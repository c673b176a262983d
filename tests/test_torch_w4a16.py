"""The port's W4A16 baseline (weight-only int4 weights, bf16 activations) held
to the JAX package: the plain version ``ref.w4a16_gemm_ref``, the packs,
dispatch kind ``w4a16`` with its reason codes, the ``ops`` wrappers and the
W4A16 dense model. The engine's four modes are held in
``test_torch_{serve,paged,ragged,spec}.py``. One test needs the card and
skips here.

Tolerances, and where bit-equality holds:
* the plain version against the reference's jitted ``w4a16_gemm_ref`` and its
  Pallas kernel run with ``interpret=True``: within 1 bf16 ULP per element.
  Bit-equality is not assumed: each group's dot has no fixed summation order
  in either framework (the port takes it in f64 and rounds it once to f32),
  and on these inputs a few elements in 10^4 round to the neighbouring bf16
  value;
* packs (``_pack_one_w4a16``, ``quantize_params("w4a16")``) bit-equal to the
  reference's op-by-op packer (its jitted packer turns the scale division
  into a reciprocal multiply, so that one is not the oracle);
* the W4A16 model's logits (forward, prefill, decode steps) rel <= 0.03, the
  bf16 model's bound of ``tests/test_torch_dense.py``: the packs are the
  same bits and every linear is within 1 bf16 ULP, so what remains is bf16
  rounding at other places in XLA's and PyTorch's CPU kernels. W4A16 against
  bf16: rel < 0.6, the reference's own sanity bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.configs import QuantSpec as JQ
from repro.core import twinquant as JT
from repro.kernels import dispatch as JDisp
from repro.kernels import ref as J
from repro.kernels.w4a16_gemm import w4a16_gemm as j_w4a16_gemm
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core import twinquant as TT
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch as TDisp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T
from repro_torch.kernels.contracts import ContractError, validate_w4a16
from repro_torch.kernels.cuda_launch import launch_counts, reset_launch_counts
from repro_torch.kernels.w4a16_gemm import w4a16_gemm
from repro_torch.models import dense as TD
from repro_torch.models.common import Linear, W4A16Linear

torch.set_num_threads(2)

KW = dict(name="w4a16", family="dense", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
          head_dim=64, d_ff=512, vocab=260)
JC, TC = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(autouse=True)
def _clean():
    TDisp.reset_dispatch_counters()
    prev = TDisp.set_force_ref(False)
    yield
    TDisp.set_force_ref(prev)
    TDisp.reset_dispatch_counters()


def _t(a) -> torch.Tensor:
    """numpy / jax array -> torch tensor (bf16 through f32, exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors (bit patterns mapped to a monotone integer line)."""
    def line(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max())


def _pack(rng, k, n, group=128):
    """A reference W4A16 pack of a seeded weight: (jax wp, jax ws)."""
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1)
    wq, ws = J.quantize_rows_ref(w, group, 4)
    return J.pack_rows_groupsplit(wq, group), ws


# ---------------------------------------------------------------------------
# the plain version against the reference
# ---------------------------------------------------------------------------

# the shapes and blocks of tests/test_kernels.py::test_w4a16_matches_ref; the
# last case adds batch dims and a bias, through both dispatch entries
CASES = [
    ((64,), 256, 128, (64, 128, 128), False),
    ((128,), 1024, 256, (128, 128, 512), False),
    ((8,), 512, 384, (8, 128, 256), False),
    ((3, 5), 512, 256, None, True),
]


@pytest.mark.parametrize("oracle", ["jitted_ref", "interpret_kernel"])
@pytest.mark.parametrize("lead,K,N,blocks,bias", CASES,
                         ids=["64x256x128", "128x1024x256", "8x512x384", "3x5x512x256_bias"])
def test_w4a16_ref_within_one_ulp_of_jax(oracle, lead, K, N, blocks, bias):
    rng = np.random.default_rng(K + N + len(lead))
    wp, ws = _pack(rng, K, N)
    x = jnp.asarray(rng.standard_normal((*lead, K)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(N).astype(np.float32) * 0.1) if bias else None
    if bias:
        # the reference's routed entry, on its oracle or its kernel
        impl = "ref" if oracle == "jitted_ref" else "kernel"
        yj = JDisp.w4a16_linear(x, wp, ws, b, group=128, impl=impl, interpret=True)
        yt = TDisp.w4a16_linear(_t(x), _t(wp), _t(ws), _t(b), group=128)
        assert TDisp.dispatch_counters() == {"w4a16/prefill": 1}
    elif oracle == "jitted_ref":
        yj = J.w4a16_gemm_ref(x, wp, ws, group=128)
        yt = T.w4a16_gemm_ref(_t(x), _t(wp), _t(ws), 128)
    else:
        bm, bn, bk = blocks
        yj = j_w4a16_gemm(x, wp, ws, group=128, block_m=bm, block_n=bn, block_k=bk,
                          interpret=True)
        yt = T.w4a16_gemm_ref(_t(x), _t(wp), _t(ws), 128)
    assert yt.shape == tuple(yj.shape) and yt.dtype == torch.bfloat16
    assert _bf16_ulps(yt, _t(yj)) <= 1


@pytest.mark.parametrize("m", [8, 33])
def test_w4a16_ref_rows_do_not_depend_on_m(m):
    """The plain version's bits for a row do not depend on the rows beside
    it (the f64 group dot), as the kernel's do not on the card: what lets
    the W4A16 engine hold its tokens across modes on the CPU too."""
    rng = np.random.default_rng(m)
    wp, ws = (_t(a) for a in _pack(rng, 512, 256))
    x = torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32)).bfloat16()
    y = T.w4a16_gemm_ref(x, wp, ws, 128)
    rows = torch.cat([T.w4a16_gemm_ref(x[i:i + 1], wp, ws, 128) for i in range(m)])
    assert torch.equal(y, rows)
    f32 = T.w4a16_gemm_f32(x, wp, ws, 128)
    assert f32.dtype == torch.float32 and torch.equal(f32.to(torch.bfloat16), y)


# ---------------------------------------------------------------------------
# packs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N,group_size", [(256, 512, 128), (512, 256, 64), (256, 384, 512)])
def test_pack_one_w4a16_bit_equal_to_reference(K, N, group_size):
    rng = np.random.default_rng(K * N)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    wb = jnp.asarray(w, jnp.bfloat16)  # model weights are bf16 in both packages
    pj = JT._pack_one_w4a16(wb.astype(jnp.float32), JQ(mode="w4a16", group_size=group_size))
    lin = TT._pack_one_w4a16(Linear(_t(wb)), QuantSpec(mode="w4a16", group_size=group_size))
    assert isinstance(lin, W4A16Linear) and lin.group == min(group_size, K)
    assert torch.equal(lin.wp, _t(pj["wp"])) and torch.equal(lin.ws, _t(pj["ws"]))


@pytest.fixture(scope="module")
def pj():
    return JD.init_params(JC, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jq16(pj):
    # op by op: the reference packer as written (see the module docstring)
    return JT.quantize_params(pj, JC, JQ(mode="w4a16"))


def _bridge(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), TC, "cpu")


def test_quantize_params_w4a16_bit_equal_to_reference(pj, jq16):
    qt = TT.quantize_params(_bridge(pj), TC, QuantSpec(mode="w4a16"))
    qb = _bridge(jq16)
    for lt, lb in zip(qt.layers, qb.layers):
        for grp in ("attn", "mlp"):
            for name, mod in getattr(lt, grp).items():
                ref_mod = getattr(lb, grp)[name]
                assert isinstance(mod, W4A16Linear) and isinstance(ref_mod, W4A16Linear)
                assert mod.group == ref_mod.group == 128
                assert torch.equal(mod.wp, ref_mod.wp) and torch.equal(mod.ws, ref_mod.ws)
    assert isinstance(qt.head, Linear)  # excluded: stays bf16
    # never fused, as in the reference
    ft = TT.fuse_params(qt)
    assert set(ft.layers[0].attn.keys()) == {"q", "k", "v", "o"}
    assert set(ft.layers[0].mlp.keys()) == {"gate", "up", "down"}


# ---------------------------------------------------------------------------
# dispatch, contracts, ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k,ref_route,port_route", [
    (16, 256, 512, ("prefill", "ok"), ("prefill", "ok")),  # tests/test_dispatch.py cases
    (16, 100, 512, ("ref", "prefill_untileable"), ("ref", "prefill_untileable")),
    (16, 256, 300, ("ref", "k_group"), ("ref", "k_group")),
    (1, 4096, 4096, ("prefill", "ok"), ("prefill", "ok")),  # one schedule for every M
    (1000, 1024, 14336, ("prefill", "ok"), ("prefill", "ok")),
    # by design (ROADMAP Queue 3): the port asks the kernel's own contract
    # (N in 64-column tiles), the reference its 128-multiple block heuristic
    (16, 192, 512, ("ref", "prefill_untileable"), ("prefill", "ok")),
])
def test_classify_w4a16_routes_and_codes(m, n, k, ref_route, port_route):
    rj = JDisp.classify_w4a16(m, n, k, 128)
    rt = TDisp.classify_w4a16(m, n, k, 128)
    assert (rj.path, rj.code) == ref_route
    assert (rt.path, rt.code) == port_route
    if rt.path == "prefill":
        bm, bn, bk = rt.blocks
        assert n % bn == 0 and bk == 128


def test_validate_w4a16_contract():
    validate_w4a16(7, 1024, 4096, 128, 64, 64, 128)
    for args, match in [((0, 64, 256, 128, 64, 64, 128), "M=0"),
                        ((8, 96, 256, 128, 64, 64, 128), "N % block_n"),
                        ((8, 64, 256, 8, 64, 64, 8), "group % 16"),
                        ((8, 64, 512, 256, 64, 64, 256), "largest group")]:
        with pytest.raises(ContractError, match=match):
            validate_w4a16(*args)


@pytest.mark.parametrize("m", [1, 8, 32, 256, 512])
@pytest.mark.parametrize("model", ["llama3-8b", "qwen3-8b"])
def test_w4a16_model_shapes_route_and_fit(model, m):
    """Every W4A16 linear of llama3-8b / qwen3-8b at M in {1, 8, 32, 256,
    512} routes to the kernel (path ``prefill``, code ``ok``) as before, and
    the launch the kernel picks for it fits the 227 KB block budget: up to
    32 rows the K-split schedule (8 warps) below 8192 columns and the
    column-split one (4 warps) from there, above 32 rows the 64 x 64 tile."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.autotune import W4A16_DECODE_COL_N, W4A16_DECODE_M
    from repro_torch.kernels.contracts import SMEM_BUDGET_BYTES, w4a16_launch

    c = get_config(model)
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    for k, n in ((c.d_model, q), (c.d_model, kv), (q, c.d_model), (c.d_model, c.d_ff),
                 (c.d_ff, c.d_model)):
        rt = TDisp.classify_w4a16(m, n, k, 128)
        assert (rt.path, rt.code) == ("prefill", "ok"), (k, n)
        warps, smem = w4a16_launch(m, n, 128)
        assert smem <= SMEM_BUDGET_BYTES
        if m <= W4A16_DECODE_M:
            assert warps == (4 if n >= W4A16_DECODE_COL_N else 8), (k, n)


@pytest.mark.parametrize("group", [16, 48, 128])
def test_validate_w4a16_admits_every_m_and_64_column_n(group):
    """The contract admits what it did before the decode schedules: any M
    >= 1 (each regime's edge included), N in whole 64-column units, a group
    of whole 16-deep steps up to 128; each launch's shared memory fits."""
    for m in (1, 7, 8, 9, 16, 17, 31, 32, 33, 64, 1000):
        for n in (64, 192, 1024, 8128, 8192, 14336):
            validate_w4a16(m, n, 4 * group, group, 64, 64, group)


def test_malformed_w4a16_pack_raises():
    rng = np.random.default_rng(5)
    wp, ws = (_t(a) for a in _pack(rng, 512, 256))
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32)).bfloat16()
    with pytest.raises(ContractError, match="scale rows"):
        TDisp.w4a16_linear(x, wp, ws[:2], group=128)
    with pytest.raises(ContractError, match="int8"):
        TDisp.w4a16_linear(x, wp.to(torch.int32), ws, group=128)
    with pytest.raises(ContractError, match="width"):
        TDisp.w4a16_linear(x, wp, ws[:, :128], group=128)
    assert TDisp.dispatch_counters() == {}


def test_w4a16_off_cpu_raises_instead_of_plain_version():
    """A ``ref`` route runs the plain version only for a CPU tensor; on any
    other device (meta, standing in for the card) it raises with its code,
    and a routed call there reaches the wrapper, which wants CUDA."""
    rng = np.random.default_rng(6)
    wp, ws = (_t(a) for a in _pack(rng, 512, 96))
    x = torch.empty(16, 512, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ContractError, match=r"ref\[prefill_untileable\]"):
        TDisp.w4a16_linear(x, wp.to("meta"), ws.to("meta"))
    assert TDisp.dispatch_counters() == {}
    wp, ws = (_t(a) for a in _pack(rng, 512, 128))
    with pytest.raises(ContractError, match="CUDA"):
        w4a16_gemm(x, wp.to("meta"), ws.to("meta"))
    xc = torch.from_numpy(rng.standard_normal((16, 512)).astype(np.float32)).bfloat16()
    reset_launch_counts()
    y = w4a16_gemm(xc, wp, ws)  # a CPU tensor: the plain version, no launch counted
    assert torch.equal(y, T.w4a16_gemm_ref(xc, wp, ws, 128))
    assert "w4a16_gemm" not in launch_counts()


def test_ops_w4a16_matmul_wrapper():
    """tests/test_kernels.py::test_w4a16_matmul_wrapper through the port's
    ops: the routed call equals the plain version; both within 1 bf16 ULP of
    the reference's oracle; ``use_ref`` forces the plain route."""
    rng = np.random.default_rng(13)
    wp, ws = _pack(rng, 256, 128)
    x = jnp.asarray(rng.standard_normal((10, 256)), jnp.bfloat16)
    y = ops.w4a16_matmul(_t(x), _t(wp), _t(ws))
    assert torch.equal(y, T.w4a16_gemm_ref(_t(x), _t(wp), _t(ws), 128))
    assert _bf16_ulps(y, _t(J.w4a16_gemm_ref(x, wp, ws))) <= 1
    y_ref = ops.w4a16_matmul(_t(x), _t(wp), _t(ws), use_ref=True)
    assert torch.equal(y, y_ref)
    assert TDisp.dispatch_counters() == {"w4a16/prefill": 1, "w4a16/ref": 1,
                                         "w4a16/ref[forced]": 1}
    assert not TDisp.force_ref_enabled()


def test_ops_twinquant_matmul_batch_bias_and_pick_blocks():
    """tests/test_kernels.py's twinquant_matmul batch/bias cases and
    pick_blocks' None for untileable shapes, through the port's ops."""
    g = torch.Generator().manual_seed(11)
    w = T.pack_twinquant_weights(torch.randn(256, 32, generator=g) * 0.1,
                                 torch.randn(32, 128, generator=g) * 0.1,
                                 torch.randn(256, 128, generator=g) * 0.05)
    x = (torch.randn(3, 5, 256, generator=g) * 2).bfloat16()
    y = ops.twinquant_matmul(x, w)
    assert y.shape == (3, 5, 128)
    assert torch.equal(y, T.dual_gemm_ref(x.reshape(15, 256), w).reshape(3, 5, 128))
    b = torch.arange(128, dtype=torch.float32) * 0.01
    yb = ops.twinquant_matmul(x, w, b, use_ref=True)
    assert torch.equal(yb, (y.float() + b).bfloat16())
    assert ops.pick_blocks(64, 100, 512, 128) is None
    assert ops.pick_blocks(64, 384, 300, 128) is None
    assert ops.pick_blocks(64, 384, 512, 128) == (64, 64, 128)


# ---------------------------------------------------------------------------
# the W4A16 model against the reference's
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


@pytest.mark.parametrize("entry", ["forward", "prefill_decode"])
def test_w4a16_model_vs_reference(pj, jq16, entry):
    pt = _bridge(jq16)
    rng = np.random.default_rng(3)
    if entry == "forward":
        toks = rng.integers(0, KW["vocab"], (2, 40)).astype(np.int32)
        TDisp.reset_dispatch_counters()
        a = _np(JD.forward(jq16, JC, jnp.asarray(toks)))
        b = _np(TD.forward(pt, TC, torch.as_tensor(toks, dtype=torch.long)))
        assert TDisp.dispatch_counters() == {"w4a16/prefill": 7 * KW["n_layers"]}
        assert _rel(a, b) <= 0.03
        bf16 = _np(JD.forward(pj, JC, jnp.asarray(toks)))
        assert _rel(bf16, b) < 0.6  # tests/test_quant_integration.py's sanity bound
        return
    bucket, length = 64, 50
    toks = rng.integers(0, KW["vocab"], (1, bucket)).astype(np.int32)
    toks[0, length:] = 0
    sj = JD.init_decode_state(JC, 1, bucket + 8)
    st = TD.init_decode_state(TC, 1, bucket + 8, device="cpu")
    lj, sj = JD.prefill(jq16, JC, jnp.asarray(toks), sj, length=jnp.asarray([length]))
    lt, st = TD.prefill(pt, TC, torch.as_tensor(toks, dtype=torch.long), st,
                        length=torch.tensor([length]))
    assert _rel(_np(lj), _np(lt)) <= 0.03
    for i in range(2):
        tok = np.array([[7 + i]], np.int32)
        lj, sj = JD.decode_step(jq16, JC, sj, jnp.asarray(tok))
        lt, st = TD.decode_step(pt, TC, st, torch.as_tensor(tok, dtype=torch.long))
        assert _rel(_np(lj), _np(lt)) <= 0.03
    assert int(st["pos"][0]) == length + 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_w4a16_kernel_close_to_plain_version_on_card():
    """On the card: the kernel within one bf16 rounding of the plain version
    run in f32 (relative error per row <= 0.004), and each row equal to a
    one-row launch (chip_smoke.py does the same at llama3-8b shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    wp, ws = (_t(a).to(dev) for a in _pack(rng, 1024, 320))
    x = torch.from_numpy(rng.standard_normal((70, 1024)).astype(np.float32)).bfloat16().to(dev)
    y = w4a16_gemm(x, wp, ws)
    y32 = T.w4a16_gemm_f32(x, wp, ws, 128)
    rel = (y.float() - y32).norm(dim=1) / y32.norm(dim=1)
    assert rel.max().item() <= 0.004
    for i in (0, 31, 69):
        assert torch.equal(y[i:i + 1], w4a16_gemm(x[i:i + 1].contiguous(), wp, ws))


def test_w4a16_linear_module_fields():
    rng = np.random.default_rng(8)
    wp, ws = (_t(a) for a in _pack(rng, 512, 64, group=64))
    mod = W4A16Linear(wp, ws)
    assert mod.group == 64
    x = torch.from_numpy(rng.standard_normal((2, 3, 512)).astype(np.float32)).bfloat16()
    y = mod(x)
    assert y.shape == (2, 3, 64)
    assert torch.equal(y.reshape(6, 64), T.w4a16_gemm_ref(x.reshape(6, 512), wp, ws, 64))
