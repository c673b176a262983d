"""The port's static analyzer (``repro_torch.analysis``): each rule on a
good and a bad snippet, the catalog, the CLI's exit codes and JSON report
(keys equal to the reference's ``render_json``), and ``src/repro_torch``
clean under every rule."""

import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis.core import Finding as JFinding, render_json as jrender_json
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.core import all_rules, analyze_paths, analyze_source, render_json

REPO = Path(__file__).resolve().parents[1]

ENGINE_BAD = {
    "EN001": """
        import torch
        class FooEngine:
            def step(self):
                n = self.pos.item()
                self.out.cpu().numpy()
                torch.cuda.synchronize()
                return self.lens.tolist()
    """,
    "EN002": """
        import torch
        from repro_torch.kernels.build import load
        def decode_step(params, x):
            f = torch.compile(lambda y: y)
            g = torch.jit.script(f)
            lib = load("w4a16_gemm")
            return g(x)
    """,
    "EN003": """
        class FooEngine:
            def admit(self, req):
                pages = self.allocator.alloc(4)
                self.insert(req, pages)
    """,
    "DC001": """
        def public_entry(x):
            return x
    """,
}
ENGINE_GOOD = {
    "EN001": """
        import torch
        class FooEngine:
            def step(self):
                n = self.pos.item()  # sync-point: the write offset
                return self.lens
            def audit(self):
                return self.lens.tolist()
    """,
    "EN002": """
        import torch
        FN = torch.compile(lambda y: y)
        def decode_step(params, x):
            return FN(x)
    """,
    "EN003": """
        class FooEngine:
            def admit(self, req):
                pages = self.allocator.alloc(4)
                try:
                    self.insert(req, pages)
                except Exception:
                    self.allocator.release(pages)
                    raise
    """,
    "DC001": '''
        """Kernel dispatch."""
        def public_entry(x):
            """Routed entry."""
            return x
    ''',
}
COUNTS = {"EN001": 5, "EN002": 3, "EN003": 1, "DC001": 2}


@pytest.mark.parametrize("rid", list(ENGINE_BAD))
def test_engine_and_docs_rules(rid):
    path = "pkg/kernels/dispatch.py" if rid == "DC001" else "pkg/launch/serve.py"
    bad = analyze_source(textwrap.dedent(ENGINE_BAD[rid]), path, rules=[rid])
    assert [f.rule for f in bad] == [rid] * COUNTS[rid], bad
    assert analyze_source(textwrap.dedent(ENGINE_GOOD[rid]), path, rules=[rid]) == []


CU = """
    extern "C" int foo_smem_bytes(int hd) { return hd; }
    // x, out, M, N
    extern "C" int foo_launch(const void* x, void* out, int M,
                              int N, void* stream) {
      return 0;
    }
"""
HELPER = """
    import ctypes
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _ARGS = [_P] * 2 + [_I] * 2

    def run_kernel(name, lib_name, fn_name, argtypes, args, device):
        pass

    def launch_pair(name, lib_name, fn_name, x):
        run_kernel(name, lib_name, fn_name, _ARGS, [x, x, 1, 1], None)
"""
WRAPPER = """
    import ctypes
    import torch
    from pkg.kernels.contracts import validate_foo
    from pkg.kernels.cuda_launch import launch_pair, run_kernel
    _ARGS = {args}

    def foo(x):
        {check}
        {sync}
        run_kernel("foo", "foo", "{entry}", _ARGS, [x, x, 1, 1], x.device)
        return launch_pair("foo", "foo", "foo_launch", x)
"""


def _tree(tmp_path, args="[ctypes.c_void_p] * 2 + [ctypes.c_int] * 2",
          check="validate_foo(x.shape)", sync="n = x.shape[0]", entry="foo_launch",
          helper_args="[_P] * 2 + [_I] * 2"):
    kern = tmp_path / "pkg" / "kernels"
    kern.mkdir(parents=True)
    (tmp_path / "pkg" / "csrc").mkdir()
    (tmp_path / "pkg" / "csrc" / "foo.cu").write_text(textwrap.dedent(CU))
    (kern / "cuda_launch.py").write_text(
        textwrap.dedent(HELPER).replace("[_P] * 2 + [_I] * 2", helper_args))
    (kern / "foo.py").write_text(textwrap.dedent(WRAPPER.format(
        args=args, check=check, sync=sync, entry=entry)))
    return tmp_path / "pkg"


def test_cuda_rules_pass_a_good_wrapper(tmp_path):
    findings, n = analyze_paths([str(_tree(tmp_path))])
    assert n == 2 and findings == [], findings


@pytest.mark.parametrize("fault,rid,count", [
    (dict(args="[ctypes.c_void_p] * 2 + [ctypes.c_int] * 3"), "CK001", 1),
    (dict(helper_args="[_P] * 3 + [_I] * 2"), "CK001", 1),
    (dict(entry="foo_missing"), "CK001", 1),
    (dict(args="make_args()"), "CK001", 1),
    (dict(check="pass"), "CK002", 1),
    (dict(check="x = validate(x)"), "CK002", 1),
    (dict(sync="n = x.sum().item()"), "CK004", 1),
    (dict(sync="torch.cuda.synchronize()"), "CK004", 1),
], ids=["arity", "helper-arity", "no-entry", "not-literal", "no-contract", "not-a-contract",
        "item", "synchronize"])
def test_cuda_rules_catch_a_planted_fault(tmp_path, fault, rid, count):
    findings, _ = analyze_paths([str(_tree(tmp_path, **fault))])
    assert [f.rule for f in findings] == [rid] * count, findings


def test_ck004_allows_a_marked_sync(tmp_path):
    pkg = _tree(tmp_path, sync="n = x.sum().item()  # sync-point: the launch's grid size")
    assert analyze_paths([str(pkg)])[0] == []


def test_catalog():
    import repro_torch.analysis.rules_cuda as rc

    assert sorted(all_rules()) == ["CK001", "CK002", "CK004", "DC001", "EN001", "EN002", "EN003"]
    assert "PK003" in rc.__doc__ and "no counterpart" in rc.__doc__
    assert all((fn.__doc__ or "").strip() for fn in all_rules().values())


@pytest.mark.parametrize("rid", ["CK001", "CK002", "CK004", "EN001", "EN002", "EN003"])
def test_cli_exits_1_on_each_planted_fault(tmp_path, rid, capsys):
    if rid.startswith("CK"):
        fault = {"CK001": dict(args="[ctypes.c_void_p] * 5"), "CK002": dict(check="pass"),
                 "CK004": dict(sync="x.tolist()")}[rid]
        target = _tree(tmp_path, **fault)
    else:
        target = tmp_path / "serve.py"
        target.write_text(textwrap.dedent(ENGINE_BAD[rid]))
    assert main([str(target)]) == 1
    assert f" {rid} " in capsys.readouterr().out


def test_cli_exit_codes_and_json_report(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    report = tmp_path / "r.json"
    assert main([str(clean), "--json", str(report)]) == 0
    doc = json.loads(report.read_text())
    assert doc["files"] == 1 and doc["findings"] == []
    bad = tmp_path / "serve.py"
    bad.write_text(textwrap.dedent(ENGINE_BAD["EN001"]))
    assert main([str(bad), "--json", str(report)]) == 1
    doc = json.loads(report.read_text())
    ref = json.loads(jrender_json([JFinding("EN001", "m", "p", 1, 0)], 1))
    assert set(doc) == set(ref)
    assert set(doc["findings"][0]) == set(ref["findings"][0])
    assert main([str(bad), "--rules", "NOPE"]) == 2
    assert main(["--list-rules"]) == 0
    assert "CK001" in capsys.readouterr().out
    assert json.loads(render_json([], 0))["tool"] == "repro_torch.analysis"


def test_port_tree_is_clean():
    findings, n = analyze_paths([str(REPO / "src" / "repro_torch")])
    assert n > 50
    assert findings == [], "\n".join(f.human() for f in findings)
