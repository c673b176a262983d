"""quantcheck of the port: the static analyzer and the runtime sanitizers.

``python -m repro_torch.analysis [paths]`` (default ``src/repro_torch``)
runs the stdlib-``ast`` rule catalog over a file tree: the CUDA wrappers'
hygiene (CK001, CK002, CK004: ``rules_cuda.py``), the engine's (EN001-EN003)
and the documented surface's docstrings (DC001). The analyzer modules
import nothing but the standard library. The runtime sanitizers of the
engine live in :mod:`repro_torch.analysis.sanitizers`, imported explicitly
by tests and ``chip_smoke.py``.
"""

from repro_torch.analysis.core import (
    Finding,
    all_rules,
    analyze_paths,
    analyze_source,
    render_human,
    render_json,
)

__all__ = [
    "Finding",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "render_human",
    "render_json",
]
