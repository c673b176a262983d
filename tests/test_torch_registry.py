"""The port's model registry against the JAX package's for every arch of
``ARCH_IDS`` (all 12, 7 families): the arch list itself, each family's
entry points, ``count_total_params`` / ``count_active_params`` (and the
configs' ``total_params`` / ``active_params``), ``SHAPE_SETS``,
``applicable_shapes`` and, for every shape at full and reduced size, the
names, shapes and dtypes of ``input_specs`` (meta tensors in the port,
``ShapeDtypeStruct``s in the reference). All pure arithmetic: equal."""

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import registry as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import registry as TR

_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def test_arch_ids_and_families():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 12
    families = {get_config(a).family for a in ARCH_IDS}
    assert families == {j_get_config(a).family for a in J_ARCH_IDS}
    assert len(families) == 7
    for a in ARCH_IDS:
        m, jm = TR.get_model(get_config(a)), JR.get_model(j_get_config(a))
        for name in ("init_params", "forward", "init_decode_state", "prefill", "decode_step",
                     "count_params"):
            assert callable(getattr(m, name)), (a, name)
        assert hasattr(m, "ragged_step") == hasattr(jm, "ragged_step"), a
    assert TR.SHAPE_SETS == JR.SHAPE_SETS


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_shapes_and_input_specs(arch, reduced):
    cfg, jc = get_config(arch, reduced), j_get_config(arch, reduced)
    assert TR.count_total_params(cfg) == JR.count_total_params(jc)
    assert TR.count_active_params(cfg) == JR.count_active_params(jc)
    assert (cfg.total_params(), cfg.active_params()) == (jc.total_params(), jc.active_params())
    assert TR.applicable_shapes(cfg) == JR.applicable_shapes(jc)
    for shape in TR.SHAPE_SETS:
        for small in (False, True):
            got, want = TR.input_specs(cfg, shape, small), JR.input_specs(jc, shape, small)
            assert got.keys() == want.keys(), (shape, small)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert (tuple(t.shape), t.dtype) == (tuple(want[k].shape),
                                                     _DT[want[k].dtype.type]), (shape, small, k)
