"""Serving-engine hygiene rules of the port (EN...; the reference's
``repro/analysis/rules_engine.py`` in torch idiom): the per-token decode
loop must not hide host syncs or build compiled code.

EN001 guards ``step`` methods of engine classes against device-to-host
transfers outside the explicit ``# sync-point`` allowlist (the convention in
``launch/serve.py``: a transfer that is PART of the serving design — the
logits download, the position read — carries the comment on its line; any
other transfer is an accidental pipeline stall, and inside a step-graph
capture an error). EN002 bans ``torch.compile``, ``torch.jit.script`` and
the kernel build's ``load`` inside step/prefill functions, where they would
rebuild per call. EN003 requires engine methods that allocate pages to
release them on every exception path: an ``alloc`` call in a method with no
``try`` whose handler/finally releases (directly or via the eviction
helpers) leaks the reservation when admission throws mid-flight.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ModuleAliases, rule

__all__ = ["en001_decode_syncs", "en002_compile_in_step", "en003_alloc_release"]

SYNC_POINT_MARK = "# sync-point"

# device-to-host syncs EN001 polices inside step methods
_ATTR_SYNC_FNS = ("item", "tolist", "cpu", "numpy")

# function names whose bodies are per-call hot paths (EN002)
_STEP_FN_NAMES = (
    "step",
    "decode_step",
    "_decode_step",
    "prefill_step",
    "_prefill_step",
    "_run_prefill",
    "ragged_step",
    "_step_ragged",
)


def _line_allowlisted(src_lines: list[str], node: ast.AST) -> bool:
    for lineno in {node.lineno, getattr(node, "end_lineno", node.lineno)}:
        if lineno and lineno <= len(src_lines):
            if SYNC_POINT_MARK in src_lines[lineno - 1]:
                return True
    return False


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of a Name / Attribute chain, '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _torch_call(call: ast.Call, aliases: ModuleAliases, dotted: str) -> bool:
    """Is ``call`` ``torch.<dotted>(...)`` under the file's alias of torch?"""
    name = _dotted(call.func)
    head, _, rest = name.partition(".")
    return rest == dotted and head in aliases.names_for("torch")


def host_sync_label(call: ast.Call, aliases: ModuleAliases):
    """The label of a host sync call (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``torch.cuda.synchronize()``), None for other calls."""
    f = call.func
    if _torch_call(call, aliases, "cuda.synchronize"):
        return "torch.cuda.synchronize()"
    if isinstance(f, ast.Attribute) and f.attr in _ATTR_SYNC_FNS and not call.args:
        return f".{f.attr}()"
    return None


@rule("EN001")
def en001_decode_syncs(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """No ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``torch.cuda.synchronize()`` in an engine's per-token ``step`` method
    (or any ``_step*`` variant, e.g. the ragged engine's ``_step_ragged``),
    outside lines explicitly marked ``# sync-point``. Every unmarked
    transfer is a hidden decode-loop stall."""
    aliases = ModuleAliases(tree)
    src_lines = src.splitlines()
    findings: list[Finding] = []

    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and "Engine" in cls.name):
            continue
        for meth in cls.body:
            if not (
                isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (meth.name == "step" or meth.name.startswith("_step"))
            ):
                continue
            for node in ast.walk(meth):
                if not isinstance(node, ast.Call):
                    continue
                label = host_sync_label(node, aliases)
                if label and not _line_allowlisted(src_lines, node):
                    findings.append(
                        Finding(
                            "EN001",
                            f"host sync {label} in {cls.name}.{meth.name} outside the "
                            f"`{SYNC_POINT_MARK}` allowlist — a hidden "
                            "decode-loop stall (mark the line or move the "
                            "transfer out of the loop)",
                            path, node.lineno, node.col_offset,
                        )
                    )
    return findings


@rule("EN002")
def en002_compile_in_step(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """No ``torch.compile(...)``, ``torch.jit.script(...)`` or kernel
    build ``load(...)`` inside step/prefill functions: code compiled or a
    library loaded per call rebuilds every step (do it in ``__init__`` or
    at module scope and reuse it)."""
    aliases = ModuleAliases(tree)
    findings: list[Finding] = []
    for fn in ast.walk(tree):
        if not (
            isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and fn.name in _STEP_FN_NAMES
        ):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = None
            if _torch_call(node, aliases, "compile"):
                what = "torch.compile"
            elif _torch_call(node, aliases, "jit.script"):
                what = "torch.jit.script"
            elif _dotted(node.func).split(".")[-1] == "load":
                what = "the kernel build's load"
            if what:
                findings.append(
                    Finding(
                        "EN002",
                        f"{what} called inside `{fn.name}` — built per call, it "
                        "rebuilds every step; hoist it to __init__ or module scope",
                        path, node.lineno, node.col_offset,
                    )
                )
    return findings


# methods matching these names count as release-on-exception helpers for
# EN003: calling one inside an except/finally hands the reservation back
# through the engine's common exit path
_RELEASE_FNS = ("release", "_release_slot", "_evict")


def _try_releases(meth: ast.AST) -> bool:
    """True when the method contains a ``try`` whose handlers or ``finally``
    release pages (directly or through the eviction helpers)."""
    for node in ast.walk(meth):
        if not isinstance(node, ast.Try):
            continue
        guarded = list(node.finalbody)
        for h in node.handlers:
            guarded.extend(h.body)
        for g in guarded:
            for sub in ast.walk(g):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _RELEASE_FNS
                ):
                    return True
    return False


@rule("EN003")
def en003_alloc_release(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """Engine methods that allocate pages must release them on all exception
    paths: every ``.alloc(...)`` call in an ``*Engine`` method must be
    dominated by a ``try`` whose except/finally hands the reservation back
    (``.release(...)`` directly, or the ``_release_slot`` / ``_evict``
    helpers). Without one, any exception between allocation and slot insert
    — a tampered pack raising a ContractError mid-prefill, a NaN guard —
    leaks the pages for the life of the engine."""
    findings: list[Finding] = []
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and "Engine" in cls.name):
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            allocs = [
                node
                for node in ast.walk(meth)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "alloc"
            ]
            if not allocs or _try_releases(meth):
                continue
            for node in allocs:
                findings.append(
                    Finding(
                        "EN003",
                        f"page allocation in {cls.name}.{meth.name} with no "
                        "try/except/finally that releases the reservation — "
                        "an exception between alloc and slot insert leaks "
                        "the pages (release in a handler, or route the exit "
                        "through _release_slot/_evict)",
                        path, node.lineno, node.col_offset,
                    )
                )
    return findings
