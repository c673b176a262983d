"""The port's dispatch layer (repro_torch.kernels.dispatch): routing by M
with the reference's paths and reason codes, the counters, the fusion
switch, the plain version for CPU tensors, and the wrappers' operand checks.
One test needs the card and skips here."""

import numpy as np
import pytest
import torch

from repro.kernels import dispatch as JD
from repro_torch.kernels import dispatch as TD
from repro_torch.kernels import ref as T
from repro_torch.kernels.contracts import ContractError
from repro_torch.kernels.cuda_launch import launch_counts, reset_launch_counts
from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group

torch.set_num_threads(2)


def _pack(seed, K, N, r, a_bits=4):
    g = torch.Generator().manual_seed(seed)
    return T.pack_twinquant_weights(torch.randn(K, r, generator=g) * 0.1,
                                    torch.randn(r, N, generator=g) * 0.1,
                                    torch.randn(K, N, generator=g) * 0.05, a_bits=a_bits)


K = 512
SEGS = ((256, 64), (128, 32), (128, 32))


def _group():
    ws = [_pack(10 + j, K, n, r) for j, (n, r) in enumerate(SEGS)]
    return ws, T.fuse_twinquant_weights(ws)


def _x(m, k=K, seed=0):
    return (torch.randn(m, k, generator=torch.Generator().manual_seed(seed)) * 2).bfloat16()


@pytest.fixture(autouse=True)
def _clean():
    TD.reset_dispatch_counters()
    prev_f, prev_r = TD.set_fusion(True), TD.set_force_ref(False)
    yield
    TD.set_fusion(prev_f)
    TD.set_force_ref(prev_r)
    TD.reset_dispatch_counters()


@pytest.mark.parametrize("case", [
    (1, 256, 512, 128, 32, 32), (8, 256, 512, 128, 32, 32), (9, 256, 512, 128, 32, 32),
    (64, 384, 512, 128, 64, 64), (8, 100, 512, 128, 32, 32), (64, 100, 512, 128, 32, 32),
    (9, 256, 300, 128, 32, 32), (4, 256, 512, 128, 32, 12), (512, 4096, 14336, 128, 128, 128),
])
def test_classify_dual_matches_reference(case):
    j, t = JD.classify_dual(*case), TD.classify_dual(*case)
    assert (t.path, t.code) == (j.path, j.code)
    assert (t.blocks is None) == (j.blocks is None)


@pytest.mark.parametrize("m", [1, 8, 9, 256])
@pytest.mark.parametrize("segs", [
    ((256, 128, 128), (64, 32, 32), (64, 32, 32)),
    ((256, 100), (64, 32), (64, 32)),
    ((4096, 1024, 1024), (128, 128, 128), (128, 128, 128)),
    ((256, 128), (64, 30), (64, 4)),
])
def test_classify_dual_group_matches_reference(m, segs):
    j = JD.classify_dual_group(m, K, 128, *segs)
    t = TD.classify_dual_group(m, K, 128, *segs)
    assert (t.path, t.code) == (j.path, j.code)
    if t.blocks is not None:
        assert all(n % t.blocks[1] == 0 for n in segs[0])


@pytest.mark.parametrize("case,port_path", [
    ((4, 192, 512, 128, 32, 32), "decode"),    # 192 % 32 == 0: GEMV blocks tile it
    ((64, 192, 512, 128, 32, 32), "prefill"),  # 192 % 64 == 0: GEMM tiles tile it
    ((4, 96, 512, 128, 32, 32), "decode"),
])
def test_classify_dual_follows_kernel_contracts_not_128_rule(case, port_path):
    """Where the reference's 128-lane rule routes ``ref`` but the Hopper
    kernels' contracts accept the shape, the port launches the kernel."""
    j, t = JD.classify_dual(*case), TD.classify_dual(*case)
    assert j.path == "ref" and t.path == port_path and t.code == "ok"
    assert case[1] % t.blocks[1] == 0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("m,n,code", [(4, 100, "decode_untileable"),
                                      (24, 96, "prefill_untileable")])
def test_untileable_shape_off_cpu_raises_instead_of_plain_version(fused, m, n, code):
    """A ``ref`` route is the plain version only for a CPU tensor: for any
    other device (meta here, standing in for the card) dispatch raises with
    the reason code, and records nothing."""
    w = _pack(6, K, n, 32)
    x = torch.empty(m, K, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ContractError, match=rf"ref\[{code}\]"):
        TD.fused_linear(x, [w]) if fused else TD.quant_linear(x, w)
    assert TD.dispatch_counters() == {}
    y = TD.fused_linear(_x(m), [w])[0] if fused else TD.quant_linear(_x(m), w)
    assert torch.equal(y, T.dual_gemm_ref(_x(m), w))
    kind = "dual_fused" if fused else "dual"
    assert TD.dispatch_counters()[f"{kind}/ref[{code}]"] == 1


def test_counters_and_routes():
    w = _pack(1, K, 256, 32)
    ws, gw = _group()
    TD.quant_linear(_x(4), w)
    TD.quant_linear(_x(24), w)
    TD.fused_linear(_x(2), gw)
    TD.fused_linear(_x(64), gw)
    TD.set_force_ref(True)
    TD.fused_linear(_x(3), gw)
    TD.set_force_ref(False)
    TD.quant_linear(_x(4), _pack(2, K, 100, 32))  # N not a whole GEMV block
    c = TD.dispatch_counters()
    assert c == {"dual/decode": 1, "dual/prefill": 1, "dual_fused/decode": 1,
                 "dual_fused/prefill": 1, "dual_fused/ref": 1, "dual_fused/ref[forced]": 1,
                 "dual/ref": 1, "dual/ref[decode_untileable]": 1}
    TD.reset_dispatch_counters()
    assert TD.dispatch_counters() == {}


def test_force_ref_routes_forced_with_same_numbers():
    w = _pack(3, K, 256, 64)
    x = _x(5)
    y = TD.quant_linear(x, w)
    TD.set_force_ref(True)
    assert torch.equal(TD.quant_linear(x, w), y)
    assert TD.dispatch_counters()["dual/ref[forced]"] == 1


@pytest.mark.parametrize("m", [3, 40])
def test_fused_equals_per_segment_and_cpu_runs_plain_version(m):
    ws, gw = _group()
    x = _x(m, seed=m)
    reset_launch_counts()
    ys = TD.fused_linear(x, gw)
    for j, w in enumerate(ws):
        assert torch.equal(ys[j], T.dual_gemm_ref(x, w))
        assert torch.equal(ys[j], TD.quant_linear(x, w))
    assert launch_counts() == {}  # CPU tensors never reach a CUDA launch


def test_set_fusion_false_runs_per_segment():
    from repro_torch.models.common import TwinQuantLinearGroup, linear_group

    ws, gw = _group()
    p = torch.nn.ModuleDict({"qkv": TwinQuantLinearGroup(gw)})
    x = _x(4)
    fused = linear_group(p, ("q", "k", "v"), "qkv", x)
    assert TD.dispatch_counters() == {"dual_fused/decode": 1}
    TD.reset_dispatch_counters()
    TD.set_fusion(False)
    per_seg = linear_group(p, ("q", "k", "v"), "qkv", x)
    assert TD.dispatch_counters() == {"dual/decode": 3}
    for a, b in zip(fused, per_seg):
        assert torch.equal(a, b)


def test_bias_and_batch_dims():
    ws, gw = _group()
    b0 = torch.arange(gw.seg_n[0], dtype=torch.float32) * 0.01
    x = _x(6).reshape(2, 3, K)
    ys = TD.fused_linear(x, gw, biases=[b0, None, None])
    assert [tuple(y.shape) for y in ys] == [(2, 3, n) for n in gw.seg_n]
    y0 = (T.dual_gemm_ref(x.reshape(6, K), ws[0]).float() + b0).bfloat16().reshape(2, 3, -1)
    assert torch.equal(ys[0], y0)


def test_malformed_pack_raises():
    w = _pack(4, K, 256, 32)
    with pytest.raises(ContractError):
        TD.quant_linear(_x(2, 256), w)  # activation K disagrees with the pack
    bad = T.TwinQuantWeights(w.up, w.us, w.vp, w.vs, w.rp.float(), w.rs, w.group, w.rgroup,
                             w.a_bits)
    with pytest.raises(ContractError):
        TD.quant_linear(_x(2), bad)


def test_wrappers_raise_on_wrong_dtype_shape_device():
    w = _pack(5, K, 256, 32)
    ws, gw = _group()
    with pytest.raises(ContractError):
        dual_gemv(_x(9), w)  # M above the decode panel
    with pytest.raises(ContractError):
        dual_gemv_group(_x(12), gw)
    with pytest.raises(ContractError):
        dual_gemm(_x(16, 300), w)  # K not whole groups
    meta_w = T.TwinQuantWeights(*(t.to("meta") for t in (w.up, w.us, w.vp, w.vs, w.rp, w.rs)),
                                w.group, w.rgroup, w.a_bits)
    with pytest.raises(ContractError, match="bf16"):
        dual_gemv(torch.empty(2, K, device="meta"), meta_w)  # float32 activation
    with pytest.raises(ContractError, match="CUDA"):
        dual_gemm(torch.empty(32, K, dtype=torch.bfloat16, device="meta"), meta_w)
    with pytest.raises(ContractError, match="CUDA"):
        dual_gemm_group(torch.empty(32, K, dtype=torch.bfloat16, device="meta"),
                        T.TwinQuantGroupWeights(
                            gw.up.to("meta"), gw.us.to("meta"),
                            tuple(t.to("meta") for t in gw.vps),
                            tuple(t.to("meta") for t in gw.vss),
                            gw.rp.to("meta"), gw.rs.to("meta"), gw.group, gw.rgroups,
                            gw.a_bits))


# The routes and reason codes the cases above pin, written out: the kernels'
# redesign (new tiles, new shared-memory layouts) leaves every one as it was.
PINNED_ROUTES = [
    ((1, 256, 512, 128, 32, 32), "decode", "ok"),
    ((8, 256, 512, 128, 32, 32), "decode", "ok"),
    ((9, 256, 512, 128, 32, 32), "prefill", "ok"),
    ((64, 384, 512, 128, 64, 64), "prefill", "ok"),
    ((8, 100, 512, 128, 32, 32), "ref", "decode_untileable"),
    ((64, 100, 512, 128, 32, 32), "ref", "prefill_untileable"),
    ((9, 256, 300, 128, 32, 32), "ref", "k_group"),
    ((4, 256, 512, 128, 32, 12), "ref", "rank_rgroup"),
    ((512, 4096, 14336, 128, 128, 128), "prefill", "ok"),
    ((4, 192, 512, 128, 32, 32), "decode", "ok"),
    ((64, 192, 512, 128, 32, 32), "prefill", "ok"),
    ((4, 96, 512, 128, 32, 32), "decode", "ok"),
]


@pytest.mark.parametrize("case,path,code", PINNED_ROUTES)
def test_pinned_routes_and_reason_codes_unchanged(case, path, code):
    r = TD.classify_dual(*case)
    assert (r.path, r.code) == (path, code)


def _model_dual_shapes(name):
    """(layer, K, segment widths, segment ranks) of every dual linear of a
    model at full width, fused as the engine fuses them, rank 128."""
    from repro_torch.configs import get_config

    c = get_config(name)
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [("qkv", c.d_model, (q, kv, kv)), ("o", q, (c.d_model,)),
            ("gate_up", c.d_model, (c.d_ff, c.d_ff)), ("down", c.d_ff, (c.d_model,))]


@pytest.mark.parametrize("m", [1, 8, 32, 256, 512])
@pytest.mark.parametrize("model", ["llama3-8b", "qwen3-8b"])
def test_model_shapes_fit_smem_and_route_to_their_kernel(model, m):
    """Every llama3-8b / qwen3-8b dual shape at M in {1, 8, 32, 256, 512}
    passes its kernel's contract, whose shared memory fits the 227 KB block
    budget, and routes to the regime's kernel as before (decode up to 8
    rows, prefill above)."""
    from repro_torch.kernels.autotune import DECODE_M_MAX, hopper_blocks
    from repro_torch.kernels.contracts import (SMEM_BUDGET_BYTES, gemm_smem_bytes,
                                               gemv_smem_bytes, validate_dual_gemm_group,
                                               validate_dual_gemv_group)

    assert gemv_smem_bytes() <= SMEM_BUDGET_BYTES and gemm_smem_bytes() <= SMEM_BUDGET_BYTES
    for layer, k, seg_n in _model_dual_shapes(model):
        seg_r = (128,) * len(seg_n)
        r = TD.classify_dual_group(m, k, 128, seg_n, seg_r, seg_r)
        assert (r.path, r.code) == ("decode" if m <= DECODE_M_MAX else "prefill", "ok"), layer
        bn = hopper_blocks(m, 128)[1]
        if m <= DECODE_M_MAX:
            validate_dual_gemv_group(m, k, 128, seg_n, seg_r, seg_r, bn, decode_m_max=DECODE_M_MAX)
        else:
            validate_dual_gemm_group(m, k, 128, seg_n, seg_r, seg_r, bn)


def test_launch_args_built_once_per_pack():
    """``launch_dual``'s constant arguments are built once per pack and
    reused: two calls on one pack give the same argument list (the very
    same ctypes objects), also when the pack object is rebuilt around the
    same tensors (as the model's modules do at every call); a pack with
    another field gets its own; the entry goes when its tensors are freed;
    the scratch is one allocation whose buffers do not overlap. Two wrapper
    calls on one pack give equal results."""
    import dataclasses
    import gc

    from repro_torch.kernels import cuda_launch as CL

    w = _pack(8, K, 256, 32)
    ws, gw = _group()
    pa = CL.pack_args(w, "dual_gemv")
    assert CL.pack_args(w, "dual_gemv") is pa and CL.pack_args(gw, "dual_gemv_group") is not pa
    assert CL.pack_args(dataclasses.replace(w), "dual_gemv") is pa
    regw = T.TwinQuantGroupWeights(gw.up, gw.us, tuple(gw.vps), tuple(gw.vss), gw.rp, gw.rs,
                                   gw.group, gw.rgroups, gw.a_bits)
    assert CL.pack_args(regw, "dual_gemv_group") is CL.pack_args(gw, "dual_gemv_group")
    total, offs = CL.scratch_layout(8, K, pa, K // 128)
    args = [CL.dual_args(4096, 8, K, pa, 1 << 20, offs, 1 << 30) for _ in range(2)]
    assert args[0] == args[1] and all(a is b for a, b in zip(args[0], args[1])
                                      if not isinstance(a, int))
    assert len(args[0]) == len(CL._DUAL_ARGS)
    assert args[0][1:5] == [t.data_ptr() for t in (w.up, w.us, w.rp, w.rs)]
    assert (pa.n, pa.r, pa.group, pa.a_bits, pa.hs_cols) == (256, 32, 128, 4, 1)
    sizes = [8 * K, 8 * (K // 128) * 4, (K // 128) * 8 * 32 * 4, 8 * 32, 8 * 1 * 4]
    assert all(o2 - o1 >= sz for o1, o2, sz in zip(offs, offs[1:] + [total], sizes))
    gpa = CL.pack_args(gw, "dual_gemv_group")
    info = [gpa._info[i] for i in range(5 * gw.n_segments)]
    assert info == [v for j in range(3) for v in (gw.n_offsets[j], gw.seg_n[j],
                                                  gw.r_offsets[j], gw.seg_r[j], gw.rgroups[j])]
    assert CL.pack_args(dataclasses.replace(w, a_bits=8), "dual_gemv").a_bits == 8
    w.rp = w.rp.clone()
    assert CL.pack_args(w, "dual_gemv") is not pa
    tmp = _pack(9, K, 256, 32)
    CL.pack_args(tmp, "dual_gemv")
    n_cached = len(CL._pack_args)
    del tmp
    gc.collect()
    assert len(CL._pack_args) == n_cached - 1
    x = _x(8)
    assert torch.equal(dual_gemv(x, w), dual_gemv(x, w))
    assert torch.equal(dual_gemm_group(_x(16), gw), dual_gemm_group(_x(16), gw))


@pytest.mark.gpu
def test_kernels_bit_equal_to_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ws, gw = _group()
    dev = torch.device("cuda")
    ws = [T.TwinQuantWeights(*(t.to(dev) for t in (w.up, w.us, w.vp, w.vs, w.rp, w.rs)),
                             w.group, w.rgroup, w.a_bits) for w in ws]
    gw = T.fuse_twinquant_weights(ws)
    for m in (1, 8, 40):
        x = _x(m).to(dev)
        y = T.dual_gemm_group_ref(x, gw)
        k = dual_gemv_group(x, gw) if m <= 8 else dual_gemm_group(x, gw)
        assert torch.equal(k, y)
        w = ws[0]
        k1 = dual_gemv(x, w) if m <= 8 else dual_gemm(x, w)
        assert torch.equal(k1, T.dual_gemm_ref(x, w))
    assert np.all([n > 0 for n in launch_counts().values()])
