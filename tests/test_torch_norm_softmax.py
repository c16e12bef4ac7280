"""LayerNorm, scaled masked softmax and bias + activation of the port
against the JAX package, on the CPU.

A CPU tensor runs each wrapper's plain PyTorch version; the JAX side runs
its jnp reference (``impl="xla"``) and its Pallas kernel in interpret mode
(``impl="interpret"``).  Inputs come from numpy with a seed.  Tolerances:

- fp32: rtol/atol 1e-5 for LayerNorm and its gradients (the same formulas;
  the row sums are taken in another order), 1e-6 for softmax (outputs in
  [0, 1]) and 1e-5 for bias_act (tanh and sigmoid of the two libraries
  differ by a few ulps);
- bf16: 2e-2, one bf16 rounding of an output of size up to ~4 (2^-8
  relative), the fp32 arithmetic inside being the same;
- fp16 (LayerNorm): the bf16 bound over 8, 2.5e-3, as fp16 keeps three
  more mantissa bits (one fp16 rounding is at most 2^-11 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import bias_act as j_bias_act
from deepspeed_tpu.ops.pallas import layer_norm as j_layer_norm
from deepspeed_tpu.ops.pallas import scaled_masked_softmax as j_softmax
from deepspeed_tpu_torch.ops import kernels as tk
from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import softmax as tsm
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
SOFTMAX_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               t.detach().float().numpy(), rtol=tol, atol=tol)


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, dy


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(8, 256), (2, 16, 128), (24, 40), (3, 1600),
                                   (8, 1600), (64, 1600)])
def test_layer_norm_matches_jax(impl, dtype, shape):
    """Small shapes and gpt2-xl's decode and prefill rows [8, 1600] and
    [64, 1600], the shapes of the serving path's LayerNorm call."""
    x, g, b, _ = _ln_inputs(shape)
    (jx, tx), (jg, tg), (jb, tb) = _pair(x, dtype), _pair(g, dtype), _pair(b, dtype)
    want = j_layer_norm(jx, jg, jb, 1e-5, impl)
    got = tln.layer_norm(tx, tg, tb, eps=1e-5)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 96), (5, 1600),
                                   (9, 2048), (3, 2056)])
def test_layer_norm_vjp_matches_jax(impl, shape):
    """(dx, dγ, dβ) of the JAX custom VJP against ``layer_norm_bwd_plain``
    and against autograd through the port's ``_LayerNorm`` (fp32, 1e-5;
    dγ and dβ are sums over at most 16 rows), at gpt2-xl's and bloom-1b7's
    widths and at a row just past the card's warp-per-row backward."""
    x, g, b, dy = _ln_inputs(shape, seed=1)
    _, vjp = jax.vjp(lambda x_, g_, b_: j_layer_norm(x_, g_, b_, 1e-5, impl),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    jdx, jdg, jdb = vjp(jnp.asarray(dy))
    tx, tg, tb, tdy = (torch.from_numpy(a) for a in (x, g, b, dy))
    dx, dg, db = tln.layer_norm_bwd_plain(tx, tg, tdy, eps=1e-5)
    assert dx.shape == tx.shape and dg.shape == tg.shape == db.shape
    for j, t in ((jdx, dx), (jdg, dg), (jdb, db)):
        _close(j, t, 1e-5)
    leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
    tln.layer_norm(*leaves, eps=1e-5).backward(tdy)
    for j, t in zip((jdx, jdg, jdb), leaves):
        _close(j, t.grad, 1e-5)


def test_layer_norm_autograd_is_the_backward_function(monkeypatch):
    """When autograd records, the gradient comes from ``layer_norm_bwd``
    (one call per backward), not from autograd through the forward's ops;
    without grad the forward is a plain call."""
    calls = []
    real = tln.layer_norm_bwd
    monkeypatch.setattr(tln, "layer_norm_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, g, b, dy = (torch.from_numpy(a) for a in _ln_inputs((4, 32), seed=2))
    y = tln.layer_norm(x, g, b)
    assert not y.requires_grad and not calls
    x.requires_grad_()
    tln.layer_norm(x, g, b).backward(dy)
    assert calls == [1] and x.grad is not None


def test_layer_norm_bwd_casts_sums_to_gammas_dtype():
    """dγ and dβ are fp32 sums cast once to γ's dtype (bf16: one rounding,
    2^-8 relative of sums of 64 products)."""
    x, g, b, dy = _ln_inputs((64, 48), seed=3)
    (jx, tx), (jg, tg), (jb, tb), (jdy, tdy) = (_pair(a, "bfloat16")
                                                for a in (x, g, b, dy))
    _, vjp = jax.vjp(lambda x_, g_, b_: j_layer_norm(x_, g_, b_, 1e-5, "xla"),
                     jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    dx, dg, db = tln.layer_norm_bwd(tx, tg, tdy, eps=1e-5)
    assert dx.dtype == dg.dtype == db.dtype == torch.bfloat16
    _close(jdx, dx, 2e-2)
    for j, t in ((jdg, dg), (jdb, db)):
        np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                                   t.float().numpy(), rtol=2e-2, atol=0.1)


def test_new_ops_count_no_launch_on_cpu_and_are_exported():
    fns = (tln.layer_norm, tk.layer_norm_bwd, tk.scaled_masked_softmax,
           tk.bias_act)
    before = [f.launches for f in fns]
    x, g, b, dy = (torch.from_numpy(a) for a in _ln_inputs((2, 8)))
    tln.layer_norm(x, g, b)
    tk.layer_norm_bwd(x, g, dy)
    tk.scaled_masked_softmax(x)
    tk.bias_act(x, b)
    assert [f.launches for f in fns] == before
    # layer_norm itself is imported from its module: at the package level
    # the function's name would shadow the module's
    assert {"layer_norm_bwd", "scaled_masked_softmax",
            "bias_act"} <= set(tk.__all__)
    assert tk.layer_norm is tln


# ---------------------------------------------------------------------------
# scaled masked softmax
# ---------------------------------------------------------------------------

def _softmax_case(name):
    """(x shape, mask or None): no mask, a 2-D keep-mask of x's shape, a
    causal [S, S] mask and a per-batch [B, 1, 1, S] padding mask that
    broadcast against 4-D scores, and a mask with a fully masked row."""
    rng = np.random.default_rng(4)
    if name == "none":
        return (6, 40), None
    if name == "2d":
        return (6, 40), (rng.random((6, 40)) > 0.3).astype(np.int32)
    if name == "causal_4d":
        return (2, 3, 16, 16), np.tril(np.ones((16, 16), np.int32))
    if name == "padding_4d":
        m = np.ones((2, 1, 1, 16), np.int32)
        m[1, ..., 9:] = 0
        return (2, 3, 16, 16), m
    m = np.ones((4, 24), np.int32)
    m[2] = 0                                   # every entry of row 2 masked
    return (4, 24), m


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["none", "2d", "causal_4d", "padding_4d",
                                  "masked_row"])
def test_scaled_masked_softmax_matches_jax(impl, dtype, case):
    shape, mask = _softmax_case(case)
    x = (np.random.default_rng(5).standard_normal(shape) * 4).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = j_softmax(jx, jm, 0.125, impl)
    got = tsm.scaled_masked_softmax(tx, tm, scale=0.125)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(want, got, SOFTMAX_TOL[dtype])
    if case == "masked_row":
        # -1e30, not -inf: the fully masked row is uniform, not NaN
        np.testing.assert_allclose(got[2].float().numpy(), 1 / 24,
                                   rtol=SOFTMAX_TOL[dtype])


def test_softmax_takes_bool_masks_and_keeps_rows_normalised():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 5, 7))
                         .astype(np.float32))
    keep = torch.from_numpy(np.random.default_rng(7).random((5, 7)) > 0.4)
    keep[:, 0] = True
    got = tsm.scaled_masked_softmax(x, keep, scale=2.0)
    want = tsm.scaled_masked_softmax(x, keep.to(torch.int32), scale=2.0)
    assert torch.equal(got, want)
    assert float(got[:, ~keep].abs().max()) == 0.0
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("shape,mshape", [
    ((2, 3, 4, 8), (4, 8)), ((2, 3, 4, 8), (2, 1, 1, 8)), ((5, 8), (5, 8)),
    ((8,), (8,)), ((2, 2, 3, 4, 8), (3, 1, 8))])
def test_softmax_mask_strides_address_the_broadcast_mask(shape, mshape):
    """The kernel's mask addressing, checked on the CPU: the offsets it
    forms from (row, col) and the strides ``_mask_strides`` hands it pick
    the same element as broadcasting the mask does."""
    rng = np.random.default_rng(8)
    x = torch.zeros(shape)
    mask = torch.from_numpy(rng.integers(0, 2, mshape).astype(np.int32))
    m, d1, d2, (s0, s1, s2, s3) = tsm._mask_strides(mask, x)
    n = shape[-1]
    rows = np.arange(x.numel() // n)
    off = ((rows // (d1 * d2)) * s0 + ((rows // d2) % d1) * s1
           + (rows % d2) * s2)[:, None] + np.arange(n)[None, :] * s3
    flat = torch.as_strided(m, (int(off.max()) + 1,), (1,))
    want = torch.broadcast_to(mask, shape).reshape(-1, n)
    assert torch.equal(flat[torch.from_numpy(off)], want)
    if len(shape) <= 4:
        assert m.data_ptr() == mask.data_ptr()       # read in place


# ---------------------------------------------------------------------------
# bias + activation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "identity"])
def test_bias_act_matches_jax(impl, dtype, act):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 8, 48)) * 3).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    (jx, tx), (jb, tb) = _pair(x, dtype), _pair(b, dtype)
    want = j_bias_act(jx, jb, act, impl)
    got = tsm.bias_act(tx, tb, act)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(want, got, TOL[dtype])


def test_bias_act_gelu_identity_used_by_the_kernel():
    """The Triton kernel writes tanh-GeLU as x * sigmoid(2u) with
    u = sqrt(2/pi) (x + 0.044715 x^3); the identity 0.5 (1 + tanh u) =
    sigmoid(2u) holds to fp32 rounding over the range activations take."""
    x = torch.linspace(-12, 12, 4801)
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    kernel_form = x / (1.0 + torch.exp(-2.0 * u))
    want = tsm.bias_act_plain(x, torch.zeros(4801), "gelu")
    torch.testing.assert_close(kernel_form, want, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(kernel_form).all()
