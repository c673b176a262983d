"""quantcheck core of the port: findings, the rule registry, file walking,
reporting (the reference's ``repro/analysis/core.py``).

The analyzer is a self-contained stdlib-``ast`` lint pass with the port's
rules (``rules_cuda.py`` / ``rules_engine.py`` / ``rules_docs.py``). It
imports nothing but the standard library: not torch, not the rest of
``repro_torch``.

A rule is a function ``(tree, src, path) -> list[Finding]`` registered with
:func:`rule`. ``python -m repro_torch.analysis src/repro_torch`` walks the
tree, runs every registered rule on every ``.py`` file, and exits nonzero on
findings.
Human-readable output is one ``path:line:col RULE message`` per finding;
``--json`` additionally writes the machine-readable report CI uploads as an
artifact.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Callable, Iterable, Optional

__all__ = [
    "Finding",
    "ModuleAliases",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
    "render_human",
    "render_json",
    "rule",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnostic, anchored to a source location."""

    rule: str
    message: str
    path: str
    line: int
    col: int
    severity: str = "error"

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


RuleFn = Callable[[ast.AST, str, str], list[Finding]]

_RULES: dict[str, RuleFn] = {}


def rule(rule_id: str) -> Callable[[RuleFn], RuleFn]:
    """Register a rule function under its catalog id (e.g. ``CK001``)."""

    def register(fn: RuleFn) -> RuleFn:
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        _RULES[rule_id] = fn
        fn.rule_id = rule_id
        return fn

    return register


def all_rules() -> dict[str, RuleFn]:
    """The registered rule catalog (imports the rule modules on first use)."""
    # imported lazily so core stays importable without the rules (and so the
    # rules can import core without a cycle)
    from repro_torch.analysis import rules_cuda, rules_docs, rules_engine  # noqa: F401

    return dict(_RULES)


class ModuleAliases:
    """Resolve the file's local names for the modules the rules care about.

    Built from the module's import statements, so a file that does
    ``import torch as th`` is analyzed under its own alias rather than the
    conventional ``torch``.
    """

    CANONICAL = {
        "torch": "torch",
        "numpy": "np",
        "ctypes": "ctypes",
    }

    def __init__(self, tree: ast.AST):
        self.alias_of: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    canon = self.CANONICAL.get(a.name)
                    if canon:
                        self.alias_of[a.asname or a.name.split(".")[0]] = canon
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    canon = self.CANONICAL.get(full)
                    if canon:
                        self.alias_of[a.asname or a.name] = canon

    def is_(self, node: ast.AST, canon: str) -> bool:
        """Is ``node`` a Name bound (via import) to the canonical module?"""
        return isinstance(node, ast.Name) and self.alias_of.get(node.id) == canon

    def names_for(self, canon: str) -> set[str]:
        return {alias for alias, c in self.alias_of.items() if c == canon}


def analyze_source(
    src: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
) -> list[Finding]:
    """Run the rule catalog (or a subset) over one source string."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                "PARSE", f"syntax error: {e.msg}", path, e.lineno or 1, e.offset or 0
            )
        ]
    catalog = all_rules()
    if rules is not None:
        catalog = {rid: catalog[rid] for rid in rules}
    findings: list[Finding] = []
    for fn in catalog.values():
        findings.extend(fn(tree, src, path))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: Iterable[str]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        root = Path(p)
        if root.is_dir():
            files.extend(sorted(root.rglob("*.py")))
        elif root.suffix == ".py":
            files.append(root)
    return files


def analyze_paths(
    paths: Iterable[str], rules: Optional[Iterable[str]] = None
) -> tuple[list[Finding], int]:
    """Analyze every ``.py`` under ``paths``; returns (findings, files seen)."""
    findings: list[Finding] = []
    files = iter_python_files(paths)
    for f in files:
        findings.extend(analyze_source(f.read_text(), str(f), rules=rules))
    return findings, len(files)


def render_human(findings: list[Finding], n_files: int) -> str:
    lines = [f.human() for f in findings]
    noun = "finding" if len(findings) == 1 else "findings"
    lines.append(f"quantcheck: {len(findings)} {noun} in {n_files} files")
    return "\n".join(lines)


def render_json(findings: list[Finding], n_files: int) -> str:
    doc = {
        "schema": 1,
        "tool": "repro_torch.analysis",
        "files": n_files,
        "findings": [dataclasses.asdict(f) for f in findings],
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"
