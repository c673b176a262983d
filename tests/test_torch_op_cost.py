"""The port's op-by-op cost model (``repro_torch.launch.op_cost``) against
the reference's HLO cost model (``repro.launch.hlo_cost.analyze_hlo``), and
the hand-written kernels' one count at the dispatch entries.

Tolerances: matmul flops are exact; a dense forward's total flops within
5% of the reference's (the port counts each elementwise op's outputs, XLA
its fused computations'). Bytes: the reference's HLO is XLA:CPU's, which
upcasts every bf16 dot to f32 (convert fusions of each weight and
activation, f32 dot operands: its 12 largest instructions), so its
bytes are not a bf16 device's; the port's (unfused, bf16) are held to at
least half of them, every reference byte at no more than twice its bf16
width. Measured at d_model 256, 2 layers, (2, 64) tokens: flops port /
reference 0.9776, bytes 0.5682 (the test prints both)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as RefConfig
from repro.launch.hlo_cost import analyze_hlo
from repro.models import dense as ref_dense
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import fuse_params, quantize_params
from repro_torch.kernels import dispatch
from repro_torch.launch.op_cost import analyze_step, top_bytes
from repro_torch.models import dense

CFG = dict(name="cost", family="dense", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
           head_dim=64, d_ff=512, vocab=260)


def test_scan_case_counts_every_matmul():
    """The reference's scan case (``test_sharding_dryrun``'s trip-count
    check) as eight 16x128 @ 128x128 matmuls run one after another: exactly
    8 * 2 * 16 * 128 * 128 flops, all f32."""
    w = torch.randn(8, 128, 128)
    x = torch.randn(16, 128)

    def layers(x, w):
        for wl in w:
            x = x @ wl
        return x

    r = analyze_step(layers, x, w)
    assert r["flops"] == 8 * 2 * 16 * 128 * 128
    assert r["flops_by_class"] == {"f32": 8 * 2 * 16 * 128 * 128}
    assert r["bytes"] == 8 * (16 * 128 + 128 * 128 + 16 * 128) * 4
    assert r["coll_bytes"] == 0 and r["kernels"] == {} and r["ops"] == 8


def test_dense_forward_against_the_reference_hlo_count():
    """A d_model-256, 2-layer dense forward: total flops within 5% of the
    reference's ``analyze_hlo`` on its jitted forward, bytes at least half
    the reference's (its XLA:CPU dots run in f32); the matmuls in bf16."""
    rcfg, cfg = RefConfig(**CFG), ModelConfig(**CFG)
    params = jax.eval_shape(lambda k: ref_dense.init_params(rcfg, k), jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    compiled = jax.jit(lambda p, t: ref_dense.forward(p, rcfg, t)).lower(params, toks).compile()
    want = analyze_hlo(compiled.as_text())
    got = analyze_step(dense.forward, dense.init_params(cfg, seed=0, device="cpu"), cfg,
                       torch.zeros((2, 64), dtype=torch.int32))
    flops_ratio, bytes_ratio = got["flops"] / want["flops"], got["bytes"] / want["bytes"]
    print(f"dense forward: flops port/reference {flops_ratio:.4f}, bytes {bytes_ratio:.4f}")
    assert abs(flops_ratio - 1) < 0.05, (got["flops"], want["flops"])
    assert got["bytes"] >= 0.5 * want["bytes"]
    assert got["flops_by_class"]["bf16"] > 0.9 * got["flops"]


def _w4a4_step():
    cfg = ModelConfig(**CFG)
    qp = fuse_params(quantize_params(dense.init_params(cfg, seed=0, device="cpu"), cfg,
                                     QuantSpec("w4a4", rank=32)))
    state = dense.init_decode_state(cfg, 4, 64, device="cpu")
    toks = torch.tensor(np.arange(4)[:, None], dtype=torch.int32)
    return cfg, qp, state, toks


@contextlib.contextmanager
def _forced():
    prev = dispatch.set_force_ref(True)
    try:
        yield
    finally:
        dispatch.set_force_ref(prev)


@contextlib.contextmanager
def _launches_invisible(monkeypatch):
    """The card's routes emulated: each kernel wrapper returns an empty
    output, as a ctypes launch does (no aten op the counter sees)."""
    def empty(n_of):
        def launch(x, w, *a, **k):
            return torch.empty((*x.shape[:-1], n_of(w)), dtype=torch.bfloat16)
        return launch

    with monkeypatch.context() as mp:
        mp.setattr(dispatch, "dual_gemv", empty(lambda w: w.ndim_out))
        mp.setattr(dispatch, "dual_gemv_group", empty(lambda w: w.ndim_out))
        mp.setattr(dispatch, "dual_gemm", empty(lambda w: w.ndim_out))
        mp.setattr(dispatch, "dual_gemm_group", empty(lambda w: w.ndim_out))
        mp.setattr(dispatch, "paged_decode_kernel", lambda q, *a, commit=True: torch.empty(
            q.shape, dtype=torch.bfloat16))
        yield


def test_w4a4_decode_step_counts_alike_on_every_route(monkeypatch):
    """A W4A4 decode step counts the same through the wrappers (their plain
    versions on the CPU), under ``set_force_ref(True)``, with launches the
    counter cannot see (the card's), and on meta tensors (the dry-run's)."""
    cfg, qp, state, toks = _w4a4_step()
    got = analyze_step(dense.decode_step, qp, cfg, state, toks)
    with _forced():
        forced = analyze_step(dense.decode_step, qp, cfg, state, toks)
    with _launches_invisible(monkeypatch):
        card = analyze_step(dense.decode_step, qp, cfg, state, toks)
    assert got == forced == card
    assert got["uncounted_calls"] == 0 and got["routed_calls"] == 4 * cfg.n_layers
    assert {k: v["calls"] for k, v in got["kernels"].items()} == {
        "dual_gemv": 2 * cfg.n_layers, "dual_gemv_group": 2 * cfg.n_layers}
    assert set(got["flops_by_class"]) == {"bf16", "f32", "int8"}
    meta_qp = fuse_params(quantize_params(
        dense.init_params(cfg, device="meta", generator=torch.Generator()), cfg,
        QuantSpec("w4a4", rank=32)))
    meta = analyze_step(dense.decode_step, meta_qp, cfg,
                        dense.init_decode_state(cfg, 4, 64, device="meta"), toks.to("meta"))
    assert meta == got


def test_paged_decode_counts_alike_through_the_kernel_route(monkeypatch):
    """The paged attention entry records its kernel's cost, read from this
    call's context lengths, whichever route it takes."""
    from repro_torch.kernels.paged_attention import paged_decode_ref

    g = torch.Generator().manual_seed(0)
    b, h, kv, hd, page, maxp = 3, 4, 2, 64, 16, 4
    q = torch.randn(b, 1, h, hd, generator=g).to(torch.bfloat16)
    kt, vt = (torch.randn(b, 1, kv, hd, generator=g).to(torch.bfloat16) for _ in range(2))
    kp, vp = (torch.randn(b * maxp, page, kv, hd, generator=g).to(torch.bfloat16)
              for _ in range(2))
    bt = torch.arange(b * maxp, dtype=torch.int32).reshape(b, maxp)
    pos = torch.tensor([0, 17, 40], dtype=torch.int32)

    def step():
        return dispatch.paged_decode(q, kp, vp, kt, vt, bt, pos, commit=False)

    got = analyze_step(step)
    with _forced():
        assert analyze_step(step) == got
    with _launches_invisible(monkeypatch):
        assert analyze_step(step) == got
    cost = got["kernels"]["paged_decode_kernel"]
    assert cost["calls"] == 1
    assert cost["flops_by_class"] == {"bf16": sum(4 * hd * h * (n + 1) for n in (0, 17, 40))}
    assert got["ops"] == 0  # the entry's body is the kernel's, not counted op by op
    assert torch.equal(step(), paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=False))


@pytest.mark.parametrize("left_out", ["dual_gemv", "dual_gemv_group"])
def test_a_kernel_cost_left_out_is_caught(monkeypatch, left_out):
    """A dispatch entry that records no cost (and counts its body op by
    op) leaves a routed call uncounted, and on the card's routes its count
    differs from the forced plain version's."""
    cfg, qp, state, toks = _w4a4_step()
    keep = dispatch._counted

    def without(name, cost, body):
        return body() if name == left_out else keep(name, cost, body)

    monkeypatch.setattr(dispatch, "_counted", without)
    with _launches_invisible(monkeypatch):
        card = analyze_step(dense.decode_step, qp, cfg, state, toks)
    with _forced():
        forced = analyze_step(dense.decode_step, qp, cfg, state, toks)
    assert card["uncounted_calls"] == forced["uncounted_calls"] == 2 * cfg.n_layers
    assert card != forced
    assert card["flops"] < forced["flops"]


def test_counting_is_off_outside_analyze_step():
    cfg, qp, state, toks = _w4a4_step()
    assert dispatch._cost_sink is None
    analyze_step(dense.decode_step, qp, cfg, state, toks)
    assert dispatch._cost_sink is None
    dense.decode_step(qp, cfg, state, toks)  # no sink: nothing recorded, nothing raised


def test_top_bytes_lists_the_largest_ops_and_kernels():
    cfg, qp, state, toks = _w4a4_step()
    rows = top_bytes(dense.decode_step, qp, cfg, state, toks, n=6)
    assert len(rows) == 6 and [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert any(r[2] == "hand-written kernel" for r in rows)
