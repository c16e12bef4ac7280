"""The port's RoPE forms against the JAX package, on the CPU.

A CPU tensor runs each form's plain version: ``apply_rotary_pos_emb`` and
``partial_rope`` (the TPU site's function, x [..., S, D]), ``rope_qk`` (q
and k in the projections' [B, S, Hx, D] layout, one table or per-row
tables, differentiable) and ``rope_qkv_rows`` (the fused decode's QKV
rows).  The JAX side is ``apply_rotary_pos_emb`` at ``impl="xla"`` (its jnp
reference) and ``impl="interpret"`` (the Pallas kernel), ``jax.vjp`` of it
for the backward, the decode paths' ``_rope_rows``, and the fused decode's
rotation written as the JAX ``decode_step`` writes it.  Inputs come from
numpy with a seed.  Tolerances: fp32 1e-5 (the same fp32 formula; XLA may
contract a product and a difference into one rounding), bf16 2e-2 and
fp16 2.5e-3 (one rounding of each output to the dtype, fp16's bound the
bf16 one over 8 as fp16 keeps three more mantissa bits), the bounds of
tests/test_torch_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdecoding
from deepspeed_tpu.models import layers as jlayers
from deepspeed_tpu.ops.pallas import apply_rotary_pos_emb as j_rope
from deepspeed_tpu.ops.pallas import rope_angles as j_rope_angles
from deepspeed_tpu_torch.ops.kernels import rope as trope
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
DTYPES = ["float32", "bfloat16", "float16"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               t.float().numpy(), rtol=TOL[dtype], atol=TOL[dtype])


def _tables(pos, rd, dtype, theta=500000.0):
    """(jax cos, jax sin, torch cos, torch sin) at ``pos`` (numpy ints, any
    shape), fp32 angles from the JAX function, cast to ``dtype`` (None:
    fp32)."""
    flat = pos.reshape(-1)
    jc, js = j_rope_angles(jnp.asarray(flat), rd, theta=theta)
    jc, js = (t.reshape(*pos.shape, rd // 2) for t in (jc, js))
    tc, ts = (torch.from_numpy(np.array(t)) for t in (jc, js))
    if dtype is not None:
        jc, js = jc.astype(JDT[dtype]), js.astype(JDT[dtype])
        tc, ts = tc.to(TDT[dtype]), ts.to(TDT[dtype])
    return jc, js, tc, ts


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 9, 4, 32), (1, 64, 8, 128)])
def test_apply_rotary_pos_emb_on_views_matches_jax(impl, dtype, shape):
    """x as the training path holds it, a [B, H, S, D] view of the
    projections' [B, S, H, D] (the kernel reads such a view in place), and
    the same view made contiguous."""
    B, S, H, D = shape
    x = _np(shape, 0)
    jx, tx = _pair(x, dtype)
    jc, js, tc, ts = _tables(np.arange(5, 5 + S), D, dtype)
    want = j_rope(jnp.swapaxes(jx, 1, 2), jc, js, impl)
    for view in (tx.transpose(1, 2), tx.transpose(1, 2).contiguous()):
        got = trope.apply_rotary_pos_emb(view, tc, ts)
        assert got.dtype == TDT[dtype] and got.shape == (B, H, S, D)
        _close(want, got, dtype)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,rd", [(64, 64), (64, 16), (128, 32)])
def test_rope_qk_matches_jax(impl, dtype, D, rd):
    """q [B, S, H, D] and k [B, S, Hkv, D] in the projections' layout, one
    table [S, rd/2] in x's dtype: the JAX rotation of the transposed q and
    k, rd < D as the JAX ``apply_partial_rope`` (its Pallas kernel on the
    rotated span, the tail concatenated)."""
    B, S, H, Hkv = 2, 12, 4, 2
    jq, tq = _pair(_np((B, S, H, D), 1), dtype)
    jk, tk = _pair(_np((B, S, Hkv, D), 2), dtype)
    jc, js, tc, ts = _tables(np.arange(S), rd, dtype)

    def jrot(x):
        x = jnp.swapaxes(x, 1, 2)
        if impl == "xla":
            return jlayers.apply_partial_rope(x, jc, js)
        return jnp.concatenate([j_rope(x[..., :rd], jc, js, impl), x[..., rd:]], -1)

    gq, gk = trope.rope_qk(tq, tk, tc, ts)
    assert gq.shape == (B, H, S, D) and gk.shape == (B, Hkv, S, D)
    assert gq.is_contiguous() and gk.is_contiguous()
    _close(jrot(jq), gq, dtype)
    _close(jrot(jk), gk, dtype)
    np.testing.assert_array_equal(gq[..., rd:].float().numpy(),
                                  tq.transpose(1, 2)[..., rd:].float().numpy())


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,rd", [(32, 32), (64, 16)])
def test_rope_backward_matches_jax_vjp(impl, dtype, D, rd):
    """The gradients of ``rope_qk`` (q and k) and of ``partial_rope``
    against ``jax.vjp`` of the JAX rotation: dq and dk come back in the
    projections' [B, S, Hx, D] layout, the tail's gradient passed
    through."""
    B, S, H, Hkv = 2, 16, 2, 1
    q, k = _np((B, S, H, D), 3), _np((B, S, Hkv, D), 4)
    dq, dk = _np((B, H, S, D), 5), _np((B, Hkv, S, D), 6)
    jc, js, tc, ts = _tables(np.arange(S), rd, dtype, theta=10000.0)

    def jrot(x):
        x = jnp.swapaxes(x, 1, 2)
        return jnp.concatenate([j_rope(x[..., :rd], jc, js, impl), x[..., rd:]], -1)

    (jq, tq), (jk, tk) = _pair(q, dtype), _pair(k, dtype)
    (jdq, tdq), (jdk, tdk) = _pair(dq, dtype), _pair(dk, dtype)
    _, vjp = jax.vjp(lambda a, b: (jrot(a), jrot(b)), jq, jk)
    want_q, want_k = vjp((jdq, jdk))
    tq.requires_grad_()
    tk.requires_grad_()
    gq, gk = trope.rope_qk(tq, tk, tc, ts)
    torch.autograd.backward((gq, gk), (tdq, tdk))
    assert tq.grad.shape == (B, S, H, D) and tk.grad.shape == (B, S, Hkv, D)
    _close(want_q, tq.grad, dtype)
    _close(want_k, tk.grad, dtype)
    x = tq.detach().transpose(1, 2).contiguous().requires_grad_()
    trope.partial_rope(x, tc, ts).backward(tdq)
    _close(jnp.swapaxes(want_q, 1, 2), x.grad, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,rd", [(64, 64), (64, 16)])
def test_rope_qk_per_row_matches_jax_rope_rows(dtype, D, rd):
    """Per-row tables [B, s, rd/2] (the unfused continuous-batching decode):
    ``rope_qk`` and ``rope_rows_plain`` against the JAX decode path's
    ``_rope_rows`` on the same transposed q and k."""
    B, s, H, Hkv = 3, 2, 4, 2
    pos = np.array([[0, 1], [300, 301], [57, 58]])
    jq, tq = _pair(_np((B, s, H, D), 7), dtype)
    jk, tk = _pair(_np((B, s, Hkv, D), 8), dtype)
    jc, js, tc, ts = _tables(pos, rd, dtype)
    gq, gk = trope.rope_qk(tq, tk, tc, ts)
    for jx, got in ((jq, gq), (jk, gk)):
        want = jdecoding._rope_rows(jnp.swapaxes(jx, 1, 2), jc, js)
        _close(want, got, dtype)
    _close(jdecoding._rope_rows(jnp.swapaxes(jq, 1, 2), jc, js),
           trope.rope_rows_plain(tq.transpose(1, 2), tc, ts), dtype)


def _jax_fused_rope_rows(t, cos, sin, rd, per_row):
    """The JAX ``decode_step``'s ``rope_rows`` (a closure there), as it
    writes it: t [B, Hx, D]; cos/sin [B, rd/2] (per-row) or [1, rd/2]."""
    half = rd // 2
    if per_row:
        c = cos[:, None].astype(jnp.float32)
        s = sin[:, None].astype(jnp.float32)
    else:
        c = cos[0].astype(jnp.float32)
        s = sin[0].astype(jnp.float32)
    x1 = t[..., :half].astype(jnp.float32)
    x2 = t[..., half:rd].astype(jnp.float32)
    rot = jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)
    if rd < t.shape[-1]:
        return jnp.concatenate([rot.astype(t.dtype), t[..., rd:]], axis=-1)
    return rot.astype(t.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("D,rd", [(128, 128), (64, 16)])
def test_rope_qkv_rows_matches_jax_fused_decode(dtype, per_row, D, rd):
    """The fused decode's rotation of the q and k heads read out of the
    [B, (H + 2 Hkv) D] QKV rows, fp32 tables at one scalar position ([1,
    rd/2], generate()) or at each row's own ([B, rd/2], serving), against
    the JAX decode_step's, and against the JAX ``_rope_rows`` at s = 1."""
    B, H, Hkv = 4, 4, 2
    jqkv, tqkv = _pair(_np((B, (H + 2 * Hkv) * D), 9), dtype)
    pos = np.array([3, 90, 700, 4095])[:B] if per_row else np.array([41])
    jc, js, tc, ts = _tables(pos, rd, None)
    gq, gk = trope.rope_qkv_rows(tqkv, tc, ts, H, Hkv, D)
    assert gq.shape == (B, H, D) and gk.shape == (B, Hkv, D) and gq.is_contiguous()
    t = jqkv[:, :(H + Hkv) * D].reshape(B, H + Hkv, D)
    want = _jax_fused_rope_rows(t, jc, js, rd, per_row)
    _close(want[:, :H], gq, dtype)
    _close(want[:, H:], gk, dtype)
    rows = jnp.broadcast_to(jc[:, None], (B, 1, rd // 2)), \
        jnp.broadcast_to(js[:, None], (B, 1, rd // 2))
    _close(jdecoding._rope_rows(t[:, :, None], *rows)[:, :H, 0], gq, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_forms_agree_on_the_cpu(dtype):
    """The plain versions are one rotation: ``rope_qk`` with one table
    equals ``partial_rope`` of each transposed tensor bit for bit, and with
    per-row tables that all hold the same positions too; the decode rows
    equal ``rope_qk`` at s = 1 with per-row tables; no form counts a launch
    on the CPU."""
    before = trope.apply_rotary_pos_emb.launches
    B, S, H, Hkv, D, rd = 2, 5, 4, 2, 64, 32
    q = torch.from_numpy(_np((B, S, H, D), 10)).to(TDT[dtype])
    k = torch.from_numpy(_np((B, S, Hkv, D), 11)).to(TDT[dtype])
    _, _, tc, ts = _tables(np.arange(S), rd, dtype)
    gq, gk = trope.rope_qk(q, k, tc, ts)
    assert torch.equal(gq, trope.partial_rope(q.transpose(1, 2), tc, ts))
    assert torch.equal(gk, trope.partial_rope(k.transpose(1, 2), tc, ts))
    rq, rk = trope.rope_qk(q, k, tc.expand(B, S, -1), ts.expand(B, S, -1))
    assert torch.equal(rq, gq) and torch.equal(rk, gk)
    qkv = torch.from_numpy(_np((B, (H + 2 * Hkv) * D), 12)).to(TDT[dtype])
    _, _, pc, ps = _tables(np.array([7, 19]), rd, None)
    dq, dk = trope.rope_qkv_rows(qkv, pc, ps, H, Hkv, D)
    q1 = qkv[:, :H * D].reshape(B, 1, H, D)
    k1 = qkv[:, H * D:(H + Hkv) * D].reshape(B, 1, Hkv, D)
    sq, sk = trope.rope_qk(q1, k1, pc[:, None], ps[:, None])
    assert torch.equal(dq, sq[:, :, 0]) and torch.equal(dk, sk[:, :, 0])
    assert trope.apply_rotary_pos_emb.launches == before


def test_rope_forms_refuse_what_no_form_rotates():
    """An odd D is not all rotated by ``apply_rotary_pos_emb`` (its tables
    must hold D/2 columns): refused on every device; the plain versions
    take whatever the JAX reference takes."""
    x = torch.ones(1, 2, 4, 7)
    with pytest.raises(ValueError, match="even D"):
        trope.apply_rotary_pos_emb(x, torch.ones(4, 3), torch.ones(4, 3))
    y = trope.partial_rope(x, torch.ones(4, 3), torch.zeros(4, 3))
    assert torch.equal(y, x)
