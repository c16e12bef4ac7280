"""The port's block quantizer against the JAX package, on the CPU.

Inputs come from numpy with a seed.  A CPU tensor runs the kernel
wrapper's plain version; the JAX side runs its Pallas kernel in interpret
mode (``impl="interpret"``) and its jnp path (``impl="xla"``).

Against the jnp path codes and scales must be EQUAL: both compute the same
fp32 absmax, the IEEE quotient ``absmax / qmax`` and round half to even
(``jnp.round``, ``torch.round``).  The interpret path is traced whole, and
XLA folds its ``absmax / qmax`` (a literal divisor there) into a product
with the fp32 reciprocal of qmax, which can differ from the quotient by one
ulp (so does any jitted JAX step).  The port keeps the quotient; against
interpret each scale is within 1 ulp, codes are equal in every block whose
scale is equal, and within one code elsewhere (a scale one ulp off can
move a value across a .5 boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quantizer as jq
from deepspeed_tpu_torch.ops.kernels import quantizer as tq
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _equal(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _same_codes(impl, jqv, jscale, q, scale):
    """Equal to the jnp path; to the interpret path as the docstring says."""
    if impl == "xla":
        _equal(jqv, q)
        _equal(jscale, scale)
        return
    js = np.asarray(jscale)
    np.testing.assert_array_max_ulp(js, scale.numpy(), maxulp=1)
    same = js == scale.numpy()
    jq_, q_ = np.asarray(jqv).astype(np.int32), q.numpy().astype(np.int32)
    np.testing.assert_array_equal(jq_[same], q_[same])
    assert np.abs(jq_ - q_).max(initial=0) <= 1


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [((4096,), 128), ((1000,), 512),
                                         ((3, 7, 131), 2048), ((5003,), 512),
                                         ((64, 96), 256)])
def test_quantize_matches_jax(impl, bits, shape, block):
    """Blocks 128 to 2048, sizes that fill every block and ragged ones."""
    x = _np(shape, 0, 3.0)
    x.reshape(-1)[:block] = 0.0                    # an all-zero block: scale 1
    jqv, jscale, jpad = jq.quantize(jnp.asarray(x), bits=bits, block=block,
                                    impl=impl)
    q, scale, pad = tq.quantize(torch.from_numpy(x), bits=bits, block=block)
    assert pad == jpad and q.dtype == torch.int8 and scale.dtype == torch.float32
    _same_codes(impl, jqv, jscale, q, scale)
    assert float(scale[0]) == 1.0
    qmax = 127 if bits == 8 else 7
    assert int(q.abs().max()) == qmax


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_quantize_bf16_input_matches_jax(impl):
    x = _np((3000,), 1, 2.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    j = jq.quantize(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                    bits=8, block=512, impl=impl)
    q, scale, pad = tq.quantize(xb, bits=8, block=512)
    _same_codes(impl, j[0], j[1], q, scale)
    assert pad == j[2]


@pytest.mark.parametrize("block", [16, 64])
def test_block_under_128_follows_the_kernel_contract(block):
    """The Pallas path clamps the block to >= 128; the jnp path keeps a
    smaller one.  The port follows the kernel on both devices."""
    x = _np((1000,), 2)
    jk = jq.quantize(jnp.asarray(x), bits=8, block=block, impl="interpret")
    jx = jq.quantize(jnp.asarray(x), bits=8, block=block, impl="xla")
    q, scale, pad = tq.quantize(torch.from_numpy(x), bits=8, block=block)
    assert q.shape == (8, 128) and jk[0].shape == (8, 128)
    assert jx[0].shape == (-(-1000 // block), block)
    _same_codes("interpret", jk[0], jk[1], q, scale)
    assert pad == jk[2]


def test_quantize_refuses_other_bit_widths():
    with pytest.raises(ValueError, match="bits"):
        tq.quantize(torch.zeros(256), bits=2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(5003,), (3, 7, 131)])
def test_dequantize_matches_jax(bits, shape):
    x = _np(shape, 3)
    jqv, jscale, jpad = jq.quantize(jnp.asarray(x), bits=bits, block=512,
                                    impl="xla")
    want = jq.dequantize(jqv, jscale, jpad, shape)
    q, scale, pad = tq.quantize(torch.from_numpy(x), bits=bits, block=512)
    got = tq.dequantize(q, scale, pad, shape)
    assert got.shape == shape and got.dtype == torch.float32
    _equal(want, got)
    bf = tq.dequantize(q, scale, pad, shape, dtype=torch.bfloat16)
    _equal(jq.dequantize(jqv, jscale, jpad, shape, jnp.bfloat16).astype(jnp.float32),
           bf.float())
    # the round trip is within half a code step of each block's scale, plus
    # the fp32 rounding of q * scale (up to 127 codes x 2^-24 of a step)
    err = (got - torch.from_numpy(x)).abs().reshape(-1)
    step = torch.repeat_interleave(scale, 512)[: err.numel()]
    assert bool((err <= (0.5 + 1e-4) * step).all())


@pytest.mark.parametrize("n", [1, 8, 1001])
def test_int4_pack_and_unpack_match_jax(n):
    codes = np.random.default_rng(n).integers(-7, 8, n).astype(np.int8)
    jp = jq.pack_int4(jnp.asarray(codes))
    tp = tq.pack_int4(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8 and tp.numel() == (n + 1) // 2
    _equal(jp, tp)
    back = tq.unpack_int4(tp, n)
    _equal(jq.unpack_int4(jp, n), back)
    np.testing.assert_array_equal(back.numpy(), codes)


def test_quantize_launches_nothing_on_the_cpu():
    before = tq.quantize.launches
    tq.quantize(torch.ones(300), bits=8, block=128)
    assert tq.quantize.launches == before
