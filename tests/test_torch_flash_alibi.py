"""ALiBi in the port's flash attention against the JAX package, on the CPU.

A CPU tensor runs the plain version (``mha_reference`` with the JAX
``_alibi_ref_bias``) and autograd takes its backward; the JAX side runs
``flash_attention(..., alibi=True)`` through its jnp reference
(``impl="xla"``) and through its Pallas kernels in interpret mode
(``impl="interpret"``, 64-row blocks, so S 128 takes two and S 200 five of
40).  Inputs are fp32 from numpy with a seed.  Tolerances: causal 1e-5, as
the non-ALiBi flash parity in tests/test_torch_train.py (the same formulas,
the softmax and the products summed in another order); without the causal
mask 1e-4, the model gradients' bound there: ALiBi's logits then reach
slope_0 * (S - 1) = 0.71 * 199 = 141 at S 200, where one fp32 rounding of a
logit is up to 8e-6 and exp carries it as a relative error into sums of up
to S terms (the JAX package's own interpret and xla paths differ by up to
5.4e-5 in the gradients at [1, 12, 200, 32]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import alibi_bias as j_alibi_bias
from deepspeed_tpu.models.layers import alibi_slopes as j_alibi_slopes
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from deepspeed_tpu_torch.models.layers import alibi_bias, alibi_slopes
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels.common import alibi_slopes_on
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
NON_CAUSAL_TOL = 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, dtype=np.float32),
                               t.detach().float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("H", [1, 4, 8, 12, 16, 25])
def test_alibi_slopes_and_bias_match_jax(H):
    """Power-of-two head counts and the interpolated ones (12, 25); the
    bias with query positions offset as for S != Sk; the card's table is
    the same numbers."""
    _close(j_alibi_slopes(H), alibi_slopes(H), 0)
    q_pos, k_pos = np.arange(5) + 3, np.arange(8)
    _close(j_alibi_bias(H, jnp.asarray(q_pos), jnp.asarray(k_pos)),
           alibi_bias(H, torch.from_numpy(q_pos), torch.from_numpy(k_pos)), 0)
    assert torch.equal(alibi_slopes_on(H, torch.device("cpu")), alibi_slopes(H))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,S,D", [(2, 4, 128, 32), (1, 12, 128, 64),
                                     (1, 12, 200, 32),     # ragged S
                                     (2, 4, 200, 64)])
def test_flash_attention_alibi_and_grads_match_jax(impl, causal, B, H, S, D):
    q, k, v, do = (_np((B, H, S, D), i) for i in range(4))
    out, vjp = jax.vjp(lambda a, b, c: j_flash(
        a, b, c, causal=causal, block_q=64, block_k=64, impl=impl, alibi=True),
        q, k, v)
    jgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (tfa.flash_attention.launches, tfa.flash_fwd_alibi_cuda.launches)
    to = tfa.flash_attention(*leaves, causal=causal, alibi=True)
    to.backward(torch.from_numpy(do))
    assert (tfa.flash_attention.launches,
            tfa.flash_fwd_alibi_cuda.launches) == before   # the plain version
    tol = TOL if causal else NON_CAUSAL_TOL
    _close(out, to, tol)
    for jg, leaf in zip(jgrads, leaves):
        _close(jg, leaf.grad, tol)


def test_alibi_changes_the_attention():
    """The bias is really applied: with and without it the outputs
    differ."""
    q, k, v = (torch.from_numpy(_np((1, 4, 64, 32), i)) for i in range(3))
    with_bias = tfa.flash_attention(q, k, v, alibi=True)
    without = tfa.flash_attention(q, k, v, alibi=False)
    assert float((with_bias - without).abs().max()) > 1e-2


def test_plain_alibi_follows_mha_reference_when_s_differs_from_sk():
    """S != Sk (not a kernel shape): query i sits at position i + Sk - S for
    the bias as for the mask, as the JAX jnp reference has it."""
    q, k, v = _np((1, 4, 16, 32), 0), _np((1, 4, 48, 32), 1), _np((1, 4, 48, 32), 2)
    want = j_flash(q, k, v, causal=True, impl="xla", alibi=True)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              alibi=True)
    _close(want, got)
