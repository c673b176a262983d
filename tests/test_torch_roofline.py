"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``, and ``kernel_cost`` against the
bounds of the kernel table (PERF.md section 6): the seven table cases and
the stacked OLMoE / DeepSeek-V3 rows, to the table's 4 decimals.

The reference's ``Roofline`` is the TPU's: it is held with the port's H100
constants swapped in, every count at the bf16 peak (no class split)."""

import pytest
import torch

import repro.launch.roofline as R
from chip_smoke import ATT, DECODE_LENS, DUAL_REP, RAGGED_CTX, RAGGED_RUNS, W4A16_REP, _ragged_rows
from repro_torch.kernels.ref import as_group, fuse_twinquant_weights, pack_twinquant_weights
from repro_torch.launch import roofline as T

COUNTS = [
    dict(flops=3.1e14, hbm_bytes=2.2e11, coll_bytes=4.0e9, chips=256, model_flops=6.0e16),
    dict(flops=1.0e12, hbm_bytes=9.0e12, coll_bytes=0.0, chips=512, model_flops=None),
    dict(flops=5.0e15, hbm_bytes=1.0e9, coll_bytes=2.5e12, chips=256, model_flops=1.0e18),
]


@pytest.mark.parametrize("counts", COUNTS, ids=["compute", "memory", "collective"])
def test_roofline_matches_the_reference_with_h100_constants(monkeypatch, counts):
    monkeypatch.setattr(R, "PEAK_FLOPS", T.PEAK_BF16)
    monkeypatch.setattr(R, "HBM_BW", T.HBM_BW)
    monkeypatch.setattr(R, "LINK_BW", T.LINK_BW)
    want = R.Roofline(**counts).to_dict()
    got = T.Roofline(**counts).to_dict()
    assert set(want) <= set(got)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12) if value is not None \
            and not isinstance(value, str) else got[key] == value, key


def test_roofline_splits_compute_and_collective_terms():
    rf = T.Roofline(flops=3e12, hbm_bytes=0.0, coll_bytes=6e9, chips=1,
                    flops_by_class={"bf16": 1e12, "int8": 1e12, "f32": 1e12},
                    coll_net_bytes=2e9)
    assert rf.t_compute == pytest.approx(1e12 / 9.89e14 + 1e12 / 1.979e15 + 1e12 / 6.7e13)
    assert rf.t_collective == pytest.approx(4e9 / 4.5e11 + 2e9 / 5e10)
    assert rf.dominant == "collective"
    got = T.from_counts({"flops": 3e12, "bytes": 1e9, "coll_bytes": 0.0,
                         "flops_by_class": {"f32": 3e12}}, chips=2, model_flops=4e12)
    assert got.t_compute == pytest.approx(3e12 / 6.7e13)
    assert got.roofline_fraction == pytest.approx((4e12 / (2 * 9.89e14)) / got.bound_time)


def _llama_dual(name):
    d, f, r = 4096, 14336, 128
    lname, m = DUAL_REP[name]
    k, seg_n = (f, (d,)) if lname == "down" else (d, (f, f))
    seg_r = (r,) * len(seg_n)
    return T.kernel_cost(name, m=m, k=k, seg_n=seg_n, seg_r=seg_r)


# PERF.md section 6's bound column (ms, what bounds it)
TABLE = {
    "dual_gemv": (0.0098, "bytes"),
    "dual_gemv_group": (0.0195, "bytes"),
    "dual_gemm": (0.0316, "operations"),
    "dual_gemm_group": (0.0632, "operations"),
    "paged_decode_kernel": (0.0075, "bytes"),
    "ragged_attention_kernel": (0.0077, "bytes"),
    "w4a16_gemm": (0.0094, "bytes"),
}


@pytest.mark.parametrize("name", list(TABLE))
def test_kernel_cost_gives_the_table_bounds(name):
    c = ATT
    if name.startswith("dual"):
        cost = _llama_dual(name)
    elif name == "paged_decode_kernel":
        cost = T.kernel_cost(name, b=c["B"], sq=1, h=c["H"], kv=c["KV"], hd=c["hd"],
                             maxp=c["maxp"], lens=DECODE_LENS, commit=False)
    elif name == "ragged_attention_kernel":
        slot, pos, _ = _ragged_rows(RAGGED_CTX, RAGGED_RUNS, 256)
        cost = T.kernel_cost(name, t=256, h=c["H"], kv=c["KV"], hd=c["hd"], b=c["B"],
                             maxp=c["maxp"], slot=slot, pos=pos, ctx=RAGGED_CTX)
    else:
        lname, m = W4A16_REP
        cost = T.kernel_cost(name, m=m, k=14336, n=4096)
    ms, by = T.bound_ms(cost)
    assert (round(ms, 4), by) == TABLE[name]


# PERF.md section 6's stacked rows: (E, d_model, d_ff_expert) and each
# kernel's (Cp, bound ms, what bounds it); rank 128, group 128
STACKED = {
    "olmoe": ((64, 2048, 1024), {"dual_gemv": (8, 0.0262, "bytes"),
                                 "dual_gemv_group": (8, 0.0518, "bytes"),
                                 "dual_gemm": (256, 0.0553, "bytes"),
                                 "dual_gemm_group": (256, 0.0906, "bytes"),
                                 "w4a16_gemm": (8, 0.0222, "bytes")}),
    "deepseek": ((256, 7168, 2048), {"dual_gemv": (8, 0.6551, "bytes"),
                                     "dual_gemv_group": (8, 1.3015, "bytes"),
                                     "dual_gemm": (512, 2.1008, "operations"),
                                     "dual_gemm_group": (512, 4.2016, "operations"),
                                     "w4a16_gemm": (8, 0.6072, "bytes")}),
}


@pytest.mark.parametrize("case", [(m, k) for m in STACKED for k in STACKED[m][1]],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_kernel_cost_gives_the_stacked_bounds(case):
    model, name = case
    (e, d, f), rows = STACKED[model]
    cp, ms_want, by_want = rows[name]
    if name == "w4a16_gemm":  # down, decode
        cost = T.kernel_cost(name, m=cp, k=f, n=d, experts=e)
    elif name in ("dual_gemv", "dual_gemm"):  # down
        cost = T.kernel_cost(name, m=cp, k=f, seg_n=(d,), seg_r=(128,), experts=e)
    else:  # gate_up
        cost = T.kernel_cost(name, m=cp, k=d, seg_n=(f, f), seg_r=(128, 128), experts=e)
    ms, by = T.bound_ms(cost)
    assert (round(ms, 4), by) == (ms_want, by_want)


@pytest.mark.parametrize("experts", [None, 3])
def test_kernel_cost_of_a_pack_equals_its_shapes(experts):
    """The count from a pack's tensors (what the dispatch entries pass)
    equals the count from its shapes, single and fused, stacked or not."""
    g = torch.Generator().manual_seed(0)
    lead = () if experts is None else (experts,)

    def pack(k, n, r):
        return pack_twinquant_weights(torch.randn(*lead, k, r, generator=g),
                                      torch.randn(*lead, r, n, generator=g),
                                      torch.randn(*lead, k, n, generator=g), a_bits=4, group=128)

    w = pack(256, 64, 32)
    gw = fuse_twinquant_weights([pack(256, 64, 32), pack(256, 128, 16)])
    e = experts or 1
    for m in (1, 9):
        assert T.kernel_cost("dual_gemv", m=m, w=w) == T.kernel_cost(
            "dual_gemv", m=m, k=256, seg_n=(64,), seg_r=(32,), experts=e)
        assert T.kernel_cost("dual_gemm", m=m, w=as_group(w)) == T.kernel_cost(
            "dual_gemm", m=m, w=w)
        assert T.kernel_cost("dual_gemm_group", m=m, w=gw) == T.kernel_cost(
            "dual_gemm_group", m=m, k=256, seg_n=(64, 128), seg_r=(32, 16), experts=e)


def test_kernel_cost_counts_only_the_live_slots_and_real_rows():
    """Attention work depends on the call's context lengths: an idle slot
    (no rows) reads no keys, a pad row (slot B) costs no operations."""
    base = dict(t=4, h=2, kv=1, hd=8, b=2, maxp=4)
    ops, nbytes = T.kernel_cost("ragged_attention_kernel", slot=[0, 0, 2, 2], pos=[5, 6, 0, 0],
                                ctx=[5, 100], **base)
    assert ops == {"bf16": 4 * 8 * 2 * (6 + 7)}
    ops2, nbytes2 = T.kernel_cost("ragged_attention_kernel", slot=[0, 0, 2, 2], pos=[5, 6, 0, 0],
                                  ctx=[5, 0], **base)
    assert (ops2, nbytes2) == (ops, nbytes)
    with pytest.raises(KeyError):
        T.kernel_cost("no_such_kernel", m=1)
