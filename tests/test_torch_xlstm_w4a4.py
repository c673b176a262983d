"""The ``xlstm`` family's W4A4 serving path on the port against the JAX
package run op by op (``jax.disable_jit()``): the reference's fused W4A4
packs (rank 16) at a d_model-256 variant of the reduced config cut to one
segment (one mLSTM and one sLSTM block), bridged; one decode step from the
state the port's gated prefill leaves.

Tolerances: the logits, the mLSTM state and the bf16 conv rows bit-equal;
the sLSTM's f32 state within rel 1e-6 (XLA's and PyTorch's log-sigmoid and
exp differ in the last bit, which the bf16 outputs do not see). The jitted
reference is not the yardstick here: it differs from itself run op by op
by rel ~0.44 on these logits (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import QuantSpec as JQ
from repro.configs import get_config as j_get_config
from repro.core import twinquant as JT
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import xlstm as TX

torch.set_num_threads(2)

QCFG = get_config("xlstm-1.3b", reduced=True).replace(d_model=256, n_layers=2)
JQCFG = j_get_config("xlstm-1.3b", reduced=True).replace(remat=False, d_model=256, n_layers=2)
_JDT = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(jnp.asarray(a, jnp.float32)), b.float().numpy()
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def test_w4a4_decode_step_bit_equal_to_reference_op_by_op():
    jp = JX.init_params(JQCFG, jax.random.PRNGKey(8))
    jf = JT.fuse_params(jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a4", rank=16)))(jp))
    qp = params_from_numpy(jax.tree.map(np.asarray, jf), QCFG, "cpu")
    toks = np.random.default_rng(3).integers(0, QCFG.vocab, (1, 11))
    _, st = TX.prefill(qp, QCFG, torch.as_tensor(toks), TX.init_decode_state(QCFG, 1, 32,
                                                                           device="cpu"))
    js = {k: jnp.asarray(v.float().numpy()).astype(_JDT[v.dtype]) for k, v in st.items()}
    with jax.disable_jit():
        lj, nj = JX.decode_step(jf, JQCFG, js, jnp.asarray([[5]]))
    lt, nt = TX.decode_step(qp, QCFG, st, torch.tensor([[5]]))
    assert torch.equal(lt, _t(lj))
    for k in ("mC", "mn", "mm", "conv", "pos"):
        assert torch.equal(nt[k], _t(nj[k])), k
    for k in ("sh", "sc", "sn", "sm"):
        assert _rel(nj[k], nt[k]) <= 1e-6, k
