"""Documentation-coverage rules of the port (DC...; the reference's
``repro/analysis/rules_docs.py``): the public serving/kernel surface must
carry docstrings.

DC001 is deliberately narrow: it polices only the modules that form the
repo's public API surface (the kernel dispatch layer and the serving
launcher — the modules README.md and docs/ point readers at), not every
helper in the tree. A public module-level function, class, or public method
of a public class without a docstring is a finding. Names with a leading
underscore (which covers dunders: the class docstring is the constructor
contract) and property setters are exempt.
"""

from __future__ import annotations

import ast
from pathlib import PurePosixPath

from repro_torch.analysis.core import Finding, rule

__all__ = ["dc001_public_docstrings"]

# repo-relative module suffixes whose public surface the rule covers
DOCUMENTED_SURFACE = (
    "kernels/dispatch.py",
    "launch/serve.py",
)


def _covered(path: str) -> bool:
    p = PurePosixPath(str(path).replace("\\", "/"))
    return any(str(p).endswith(suffix) for suffix in DOCUMENTED_SURFACE)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _has_docstring(node: ast.AST) -> bool:
    return ast.get_docstring(node, clean=False) is not None


@rule("DC001")
def dc001_public_docstrings(tree: ast.AST, src: str, path: str) -> list[Finding]:
    """Public functions, classes, and methods of the documented API surface
    (``kernels/dispatch.py``, ``launch/serve.py``) must have docstrings —
    docs/kernels.md and docs/serving.md link into this surface, and an
    undocumented entry point there is a docs regression, not a style nit."""
    if not _covered(path):
        return []
    findings: list[Finding] = []

    def flag(node: ast.AST, what: str, name: str) -> None:
        findings.append(
            Finding(
                "DC001",
                f"public {what} `{name}` on the documented API surface has no "
                "docstring (see docs/ and README.md; underscore-prefix it if "
                "it is genuinely internal)",
                path, node.lineno, node.col_offset,
            )
        )

    assert isinstance(tree, ast.Module)
    if not _has_docstring(tree):
        findings.append(
            Finding(
                "DC001",
                "documented-surface module has no module docstring",
                path, 1, 0,
            )
        )
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name) and not _has_docstring(node):
                flag(node, "function", node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            if not _has_docstring(node):
                flag(node, "class", node.name)
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if not _public(meth.name):
                    continue
                # a documented property getter covers its setter
                if any(
                    isinstance(d, ast.Attribute) and d.attr == "setter"
                    for d in meth.decorator_list
                ):
                    continue
                if not _has_docstring(meth):
                    flag(meth, "method", f"{node.name}.{meth.name}")
    return findings
