"""The port stands alone: no module of src/repro_torch/ (nor chip_smoke.py,
nor the 4-rank tests' rank body) imports JAX or anything of the JAX
package ``repro``, and every module
imports under the CPU-only PyTorch of the test machine."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# the rank body of the 4-rank tests is spawned on its own: it stands alone too
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                      REPO / "tests" / "torch_dist_worker.py"]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro", "flax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_port_module_imports():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        importlib.import_module(".".join(p for p in rel.parts if p != "__init__"))
