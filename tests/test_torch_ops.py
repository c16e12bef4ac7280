"""The port's kernel modules against the JAX package, on the CPU.

A CPU tensor runs each wrapper's plain PyTorch version; the JAX side runs
its jnp reference (``impl="xla"``) and its Pallas kernel in interpret mode
(``impl="interpret"``).  Inputs come from numpy with a seed.  Tolerances:
fp32 1e-5 (same formula, different reduction order); bf16 2e-2 (one bf16
rounding of each output); fp16 (RMSNorm) 2.5e-3, the bf16 bound over 8, as
fp16 keeps three more mantissa bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import layers as jlayers
from deepspeed_tpu.ops.pallas import apply_rotary_pos_emb as j_rope
from deepspeed_tpu.ops.pallas import rms_norm as j_rms_norm
from deepspeed_tpu.ops.pallas import rope_angles as j_rope_angles
from deepspeed_tpu_torch.models import layers as tlayers
from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import rope as trope
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(8, 256), (2, 16, 128), (24, 96), (8, 4096),
                                   (64, 4096)])
def test_rms_norm_matches_jax(impl, dtype, shape):
    """Small shapes and llama3-8b's decode and prefill rows [8, 4096] and
    [64, 4096], the shapes of the serving path's RMSNorm call."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    want = j_rms_norm(jx, jg, 1e-5, impl)
    got = tln.rms_norm(tx, tg, eps=1e-5)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(want, got, dtype)


def test_rms_norm_counts_no_launch_on_cpu():
    before = tln.rms_norm.launches
    tln.rms_norm(torch.ones(2, 8), torch.ones(8))
    assert tln.rms_norm.launches == before


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_angles_match_jax(theta):
    pos = np.arange(0, 300, 7, dtype=np.int32)
    jc, js = j_rope_angles(jnp.asarray(pos), 64, theta=theta)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), 64, theta=theta)
    # cos/sin of angles up to ~300 rad: a few fp32 ulps of the angle
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), atol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 16, 32), (2, 2, 8, 64)])
def test_rope_matches_jax(impl, dtype, shape):
    rng = np.random.default_rng(1)
    S, D = shape[-2], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    ang = rng.uniform(-3, 3, (S, D // 2)).astype(np.float32)
    (jx, tx) = _pair(x, dtype)
    (jc, tc), (js, ts) = _pair(np.cos(ang), dtype), _pair(np.sin(ang), dtype)
    want = j_rope(jx, jc, js, impl)
    got = trope.apply_rotary_pos_emb(tx, tc, ts)
    assert got.dtype == TDT[dtype]
    _close(want, got, dtype)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_rope_matches_jax(impl, dtype):
    """gpt-neox rotary_pct: the first rope_dim dims rotate, the rest pass
    through (port's apply_partial_rope vs the JAX rotation of the same
    span, concatenated with the untouched tail)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 8, 64)).astype(np.float32)
    rot = 16                                     # rotary_pct 0.25 of 64
    (jx, tx) = _pair(x, dtype)
    jc, js = j_rope_angles(jnp.arange(8), rot, theta=10000.0)
    tc, ts = trope.rope_angles(torch.arange(8), rot, theta=10000.0)
    jc, js = jc.astype(JDT[dtype]), js.astype(JDT[dtype])
    tc, ts = tc.to(TDT[dtype]), ts.to(TDT[dtype])
    if impl == "xla":
        want = jlayers.apply_partial_rope(jx, jc, js)
    else:
        want = jnp.concatenate(
            [j_rope(jx[..., :rot], jc, js, impl),
             jx[..., rot:]], axis=-1)
    got = tlayers.apply_partial_rope(tx, tc, ts)
    _close(want, got, dtype)
    np.testing.assert_array_equal(got[..., rot:].float().numpy(),
                                  tx[..., rot:].float().numpy())


def test_kernel_choice_is_by_device():
    from deepspeed_tpu_torch.ops.kernels.common import use_kernel

    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))


def test_repeat_kv_and_alibi_match_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jlayers._repeat_kv(jnp.asarray(k), 4)),
        tlayers._repeat_kv(torch.from_numpy(k), 4).numpy())
    for h in (8, 12):
        np.testing.assert_allclose(np.asarray(jlayers.alibi_slopes(h)),
                                   tlayers.alibi_slopes(h).numpy(), rtol=1e-6)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    for name in ("silu", "gelu", "gelu_exact", "relu"):
        np.testing.assert_allclose(
            np.asarray(jlayers.activation_fn(name)(jnp.asarray(x))),
            tlayers.activation_fn(name)(torch.from_numpy(x)).numpy(),
            rtol=1e-5, atol=1e-6)
