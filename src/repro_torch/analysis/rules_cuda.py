"""CUDA-wrapper hygiene rules of the port (CK...): the counterparts of the
reference's Pallas rules (``repro/analysis/rules_pallas.py``, PK001-PK004)
for the ctypes wrappers in ``kernels/*.py`` and the ``extern "C"`` entries
they launch in ``csrc/*.cu``.

* CK001 (for PK001, launch geometry): the argtypes list a wrapper passes to
  ``run_kernel`` (directly, or through a helper such as ``launch_dual``)
  has one entry per parameter of the C entry it names, the stream
  ``run_kernel`` appends aside. ctypes does not check a count: a mismatch
  is silent corruption.
* CK002 (for PK002, divisibility): a public wrapper that reaches a launch
  calls a ``validate_*`` contract of ``kernels/contracts.py`` before it.
* CK004 (for PK004, host work in the kernel path): no host sync
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``) in a function that reaches a launch,
  outside ``# sync-point`` lines: a step graph captures these wrappers, and
  a sync during capture fails.

PK003 (an index map that pins its operand) has no counterpart: the port
has no BlockSpecs; a CUDA kernel computes its own offsets.

A launch is a call of ``run_kernel`` or of a module-level function that
calls it (``launch_dual``); the C source is
``<package>/csrc/<lib_name>.cu`` beside the wrapper's ``kernels/``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.core import Finding, ModuleAliases, rule
from repro_torch.analysis.rules_engine import _line_allowlisted, host_sync_label

__all__ = ["ck001_launch_arity", "ck002_contract_first", "ck004_host_sync_in_launch"]

LAUNCH_FN = "run_kernel"
_C_ENTRY = r'extern\s+"C"\s+\w[\w\s\*]*?\b{name}\s*\(([^)]*)\)'


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _module_lists(tree: ast.AST) -> dict[str, ast.expr]:
    """Module-level ``NAME = <expr>`` assignments."""
    out = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _list_len(expr: ast.expr, env: dict, depth: int = 0) -> Optional[int]:
    """Length of a list expression built from literals, ``+``, ``* int`` and
    module-level names; None when it is not that."""
    if depth > 20:
        return None
    if isinstance(expr, (ast.List, ast.Tuple)):
        return len(expr.elts)
    if isinstance(expr, ast.Name) and expr.id in env:
        return _list_len(env[expr.id], env, depth + 1)
    if isinstance(expr, ast.BinOp):
        if isinstance(expr.op, ast.Add):
            a, b = _list_len(expr.left, env, depth + 1), _list_len(expr.right, env, depth + 1)
            return None if a is None or b is None else a + b
        if isinstance(expr.op, ast.Mult):
            for lst, k in ((expr.left, expr.right), (expr.right, expr.left)):
                if isinstance(k, ast.Constant) and isinstance(k.value, int):
                    n = _list_len(lst, env, depth + 1)
                    return None if n is None else n * k.value
    return None


def _str(node: ast.expr) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None


def _c_params(csrc: Path, lib: str, fn: str) -> Optional[int]:
    """Parameter count of ``extern "C" ... fn(...)`` in ``csrc/<lib>.cu``."""
    cu = csrc / f"{lib}.cu"
    if not cu.is_file():
        return None
    m = re.search(_C_ENTRY.format(name=re.escape(fn)), cu.read_text())
    if not m:
        return None
    params = [p.strip() for p in m.group(1).split(",") if p.strip()]
    return 0 if params in ([], ["void"]) else len(params)


def _launch_helpers(path: str) -> dict[str, tuple[int, int, Optional[int]]]:
    """Helpers in the wrapper's sibling modules that call ``run_kernel``
    with their own parameters as lib / entry names: name -> (index of the
    lib parameter, index of the entry parameter, argtypes length)."""
    out = {}
    for sib in sorted(Path(path).parent.glob("*.py")):
        try:
            tree = ast.parse(sib.read_text())
        except (SyntaxError, OSError, UnicodeDecodeError):
            continue
        env = _module_lists(tree)
        for fn in getattr(tree, "body", []):
            if not isinstance(fn, ast.FunctionDef) or fn.name == LAUNCH_FN:
                continue
            params = [a.arg for a in fn.args.args]
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and _call_name(call) == LAUNCH_FN \
                        and len(call.args) >= 4:
                    lib, ent = call.args[1], call.args[2]
                    if isinstance(lib, ast.Name) and isinstance(ent, ast.Name) \
                            and lib.id in params and ent.id in params:
                        out[fn.name] = (params.index(lib.id), params.index(ent.id),
                                        _list_len(call.args[3], env))
    return out


def _launches(fn: ast.AST, helpers: dict) -> list[ast.Call]:
    return [c for c in ast.walk(fn) if isinstance(c, ast.Call)
            and (_call_name(c) == LAUNCH_FN or _call_name(c) in helpers)]


def _functions(tree: ast.AST) -> list[ast.FunctionDef]:
    return [n for n in getattr(tree, "body", []) if isinstance(n, ast.FunctionDef)]


def _in_kernels(path: str) -> bool:
    return Path(path).parent.name == "kernels"


@rule("CK001")
def ck001_launch_arity(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """Every argtypes list a wrapper passes to a launch (``run_kernel``, or
    a helper that forwards to it) has as many entries as the parameters of
    the ``extern "C"`` entry it names in ``csrc/<lib>.cu``, less the stream
    the launch appends; and that entry exists. A count ctypes does not check
    is silent corruption."""
    if not _in_kernels(path):
        return []
    csrc = Path(path).parent.parent / "csrc"
    helpers = _launch_helpers(path)
    env = _module_lists(tree)
    findings: list[Finding] = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        name = _call_name(call)
        if name == LAUNCH_FN and len(call.args) >= 4:
            lib, ent = _str(call.args[1]), _str(call.args[2])
            n_args = _list_len(call.args[3], env)
        elif name in helpers:
            li, ei, n_args = helpers[name]
            lib = _str(call.args[li]) if len(call.args) > li else None
            ent = _str(call.args[ei]) if len(call.args) > ei else None
        else:
            continue
        if lib is None or ent is None:
            continue  # a helper's own forwarding call: checked at its callers
        n_c = _c_params(csrc, lib, ent)
        if n_c is None:
            findings.append(Finding(
                "CK001", f"launch of `{ent}` names no extern \"C\" entry of "
                f"csrc/{lib}.cu", path, call.lineno, call.col_offset))
        elif n_args is None:
            findings.append(Finding(
                "CK001", f"launch of `{ent}`: its argtypes list is not a literal "
                "length (build it from list literals, + and * int)",
                path, call.lineno, call.col_offset))
        elif n_args != n_c - 1:
            findings.append(Finding(
                "CK001", f"launch of `{ent}` passes {n_args} argtypes; csrc/{lib}.cu's "
                f"entry takes {n_c - 1} besides the stream — ctypes would pass "
                "garbage or drop arguments", path, call.lineno, call.col_offset))
    return findings


@rule("CK002")
def ck002_contract_first(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """A public wrapper in ``kernels/*.py`` that reaches a launch calls a
    ``validate_*`` contract (``kernels/contracts.py``) before its first
    launch: the kernels do not check their tiling themselves, and a shape
    no tile covers reads or writes out of bounds."""
    if not _in_kernels(path):
        return []
    helpers = _launch_helpers(path)
    findings: list[Finding] = []
    for fn in _functions(tree):
        if fn.name.startswith("_") or fn.name in helpers:
            continue
        launches = _launches(fn, helpers)
        if not launches:
            continue
        first = min(c.lineno for c in launches)
        checked = any(isinstance(c, ast.Call) and _call_name(c).startswith("validate_")
                      and c.lineno < first for c in ast.walk(fn))
        if not checked:
            findings.append(Finding(
                "CK002", f"public wrapper `{fn.name}` launches a kernel with no "
                "`validate_*` contract call before it (kernels/contracts.py)",
                path, fn.lineno, fn.col_offset))
    return findings


@rule("CK004")
def ck004_host_sync_in_launch(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """No host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize()``) in a ``kernels/`` function that reaches a
    launch, outside ``# sync-point`` lines: the engine captures its step,
    these wrappers included, in a CUDA graph, where a sync fails."""
    if not _in_kernels(path):
        return []
    aliases = ModuleAliases(tree)
    helpers = _launch_helpers(path)
    src_lines = src.splitlines()
    findings: list[Finding] = []
    for fn in _functions(tree):
        if fn.name != LAUNCH_FN and fn.name not in helpers and not _launches(fn, helpers):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            label = host_sync_label(node, aliases)
            if label and not _line_allowlisted(src_lines, node):
                findings.append(Finding(
                    "CK004", f"host sync {label} in `{fn.name}`, which reaches a kernel "
                    "launch — it fails inside a step-graph capture (mark the line "
                    "`# sync-point` with its reason, or move it out)",
                    path, node.lineno, node.col_offset))
    return findings
