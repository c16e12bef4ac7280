"""Dropout with MoE Random Token Selection against the JAX package, on
the CPU: mixtral-tiny with ``moe_use_rts`` under a capacity that drops
tokens, where each layer's MLP key splits into the RTS permutation's key
and the dropout key.  Tolerances as in ``tests/test_torch_dropout.py``:
the same permutations and masks on both sides, so the engines agree to the
fp32 model's summation-order differences (losses rtol 1e-5, weights atol
1e-4) and the MoE block's outputs within 1e-5.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.utils import prng
from tests import test_torch_dropout as dense
from tests.test_torch_dropout import (POLICIES, _np,  # noqa: F401 (fixtures)
                                      partitionable_threefry, restore_mesh)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "none")
def test_mixtral_rts_dropout_training_follows_the_jax_engine(policy, restore_mesh):
    dense.test_dropout_training_follows_the_jax_engine("mixtral_rts", policy, None)


def test_moe_rts_permutation_from_a_key_is_jax_s():
    """With a key, Random Token Selection takes ``jax.random.permutation``:
    under a capacity that drops tokens, the same tokens are kept and the
    outputs agree."""
    D, E, F = 16, 4, 24
    cfg = SimpleNamespace(num_experts=E, num_experts_per_tok=2,
                          moe_capacity_factor=0.25, moe_min_capacity=1,
                          moe_drop_tokens=True, moe_use_rts=True,
                          moe_dispatch="scatter", moe_q_dispatch=False,
                          activation="silu", glu=True)
    p = {"gate_w": _np((D, E), 1), "w_up": _np((E, D, F), 2, 0.2),
         "w_gate": _np((E, D, F), 3, 0.2), "w_down": _np((E, F, D), 4, 0.2)}
    x = _np((1, 40, D), 5)
    for seed in (5, 6):
        ty, taux = tmoe.moe_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg,
                                key=prng.prng_key(seed))
        jy, jaux = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), cfg, rng=jax.random.PRNGKey(seed))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        kept = np.abs(ty.numpy()).sum(-1) > 0
        np.testing.assert_array_equal(kept, np.abs(np.asarray(jy)).sum(-1) > 0)
        assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


