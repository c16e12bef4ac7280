"""The port's kernels against their plain versions, on the CUDA card.

Marked ``cuda``: they skip where there is no card (the skip is decided
inside the ``cuda_device`` fixture, so every worker collects the same
tests).  Run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: fp32 rtol/atol 1e-5 for the elementwise kernels (same
formula, a different reduction order); 1e-4 for the decode GEMVs (fp32
sums of up to 14336 products in another order: the error grows as
sqrt(K) * 2^-24 of the partial sums, about 1e-5 at K = 14336) and 2e-4 for
attention (an online softmax against a dense one, as
tests/unit/test_fused_decode.py holds the Pallas kernel); bf16 rtol/atol
2e-2 (one bf16 rounding of each output, and of the normalised rows or the
activation before a product).  The training kernels: flash attention
forward 2e-4 fp32 / 2e-2 bf16 (the decode attention bounds) and, since late
causal rows are small (|o| ~ 0.04 at S 2048) beside that atol, a relative
Frobenius error of 1e-5 fp32 / 1e-2 bf16 (p and o rounded to bf16), its gradients
as a relative Frobenius error, 1e-4 fp32 (sums of up to S products of
recomputed probabilities in another order) and 2e-2 bf16 (p and ds rounded
to bf16 before each product, as the reference kernel does); RMSNorm dx
1e-5 fp32 / 2e-2 bf16 and dγ, a sum over all rows, 1e-4 relative fp32 /
2e-2 bf16; Adam 1e-6 (the same fp32 formula, sqrt and division rounded
alike, three steps).  LayerNorm as RMSNorm: y and dx 1e-5 fp32 / 2e-2
bf16, dγ and dβ 1e-4 relative fp32 / 2e-2 bf16.  Softmax: 1e-6 fp32 (outputs
in [0, 1]; another summation order) and bf16 one rounding of each output,
2^-8 relative (rtol 8e-3 with a 1e-6 floor): an absolute 2e-2 would let the
small probabilities of a 1024-wide row be wholly wrong.  bias_act 1e-5 fp32
(exp-based GeLU and SiLU against tanh and sigmoid) / 2e-2 bf16.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import decode as tdec
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels import fused_adam as tadam
from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import rope as trope
from deepspeed_tpu_torch.ops.kernels import softmax as tsm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GEMV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' fp32 products in full fp32, as the kernels' FFMA
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dtype, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a) * scale).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (64, 4096), (8192, 2048),
                                   (3, 5, 4096), (7, 100)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, shape):
    """Path shapes (decode rows = num_slots, prefill rows = chunk, llama-1b4
    training rows = micro * S) plus an odd row length that takes the
    element-by-element path."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    before = tln.rms_norm.launches
    got = tln.rms_norm(x, g, eps=1e-5)
    torch.cuda.synchronize()
    assert tln.rms_norm.launches == before + 1
    want = tln.rms_norm_plain(x, g, eps=1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_rms_norm_kernel_refuses_bad_inputs(cuda_device):
    x = torch.ones(4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tln.rms_norm(x.t(), torch.ones(4, device=cuda_device))
    with pytest.raises(TypeError):
        tln.rms_norm(x, torch.ones(64, device=cuda_device,
                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tln.rms_norm(x, torch.ones(32, device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 64, 128), (1, 8, 64, 128),
                                   (4, 16, 2048, 128), (1, 32, 17, 128),
                                   (2, 3, 5, 48)])
def test_rope_kernel_matches_plain(cuda_device, dtype, shape):
    S, D = shape[-2], shape[-1]
    x = _randn(shape, 2, dtype, cuda_device)
    pos = torch.arange(100, 100 + S, device=cuda_device)
    cos, sin = trope.rope_angles(pos, D, theta=500000.0)
    cos, sin = cos.to(dtype), sin.to(dtype)
    before = trope.apply_rotary_pos_emb.launches
    got = trope.apply_rotary_pos_emb(x, cos, sin)
    torch.cuda.synchronize()
    assert trope.apply_rotary_pos_emb.launches == before + 1
    want = trope.rope_plain(x, cos, sin)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_backward_is_the_kernel_with_negated_sin(cuda_device, dtype):
    """llama-1b4's training q: the backward launches the same kernel with
    -sin, against the plain version with -sin."""
    x = _randn((4, 16, 2048, 128), 3, dtype, cuda_device).requires_grad_()
    dy = _randn((4, 16, 2048, 128), 4, dtype, cuda_device)
    cos, sin = trope.rope_angles(torch.arange(2048, device=cuda_device), 128)
    cos, sin = cos.to(dtype), sin.to(dtype)
    before = trope.apply_rotary_pos_emb.launches
    trope.apply_rotary_pos_emb(x, cos, sin).backward(dy)
    torch.cuda.synchronize()
    assert trope.apply_rotary_pos_emb.launches == before + 2
    _close(x.grad, trope.rope_plain(dy, cos, -sin), TOL[dtype])


def test_rope_kernel_refuses_bad_inputs(cuda_device):
    x = torch.ones(1, 2, 4, 8, device=cuda_device)
    cos = torch.ones(4, 4, device=cuda_device)
    with pytest.raises(ValueError):
        trope.apply_rotary_pos_emb(x.transpose(1, 2), cos, cos)
    with pytest.raises(ValueError):
        trope.apply_rotary_pos_emb(x, cos[:3], cos[:3])


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _counted(fn, *args, **kw):
    """Call a kernel wrapper; check it counted exactly one launch."""
    before = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,N,kind,bias", [
    (8, 4096, 6144, "rmsnorm", False),      # llama3-8b decode
    (3, 256, 768, "layernorm", True),
    (11, 128, 64, "rmsnorm", True),         # two batch passes, one tile
    (1, 96, 40, "layernorm", False)])       # a ragged last tile
def test_fused_norm_qkv_kernel_matches_plain(cuda_device, dtype, B, D, N,
                                             kind, bias):
    x = _randn((B, D), 0, dtype, cuda_device, 2.0)
    scale = _randn((D,), 1, dtype, cuda_device) * 0.1 + 1
    nb = _randn((D,), 2, dtype, cuda_device)
    w = _randn((D, N), 3, dtype, cuda_device, D ** -0.5)
    bq = _randn((N,), 4, dtype, cuda_device) if bias else None
    got = _counted(tdec.fused_norm_qkv, x, scale, nb, w, bq, kind=kind,
                   eps=1e-5)
    want = tdec._norm_qkv_ref(x, scale, nb, w, bq, kind=kind, eps=1e-5)
    assert got.dtype == dtype and got.shape == (B, N)
    _close(got, want, GEMV_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,D,kind,parallel,bias", [
    (8, 4096, 4096, "rmsnorm", False, False),   # llama3-8b decode
    (3, 192, 256, "layernorm", False, True),
    (10, 128, 96, "layernorm", True, True),
    (2, 64, 32, "rmsnorm", True, False)])
def test_fused_proj_norm_kernel_matches_plain(cuda_device, dtype, B, M, D,
                                              kind, parallel, bias):
    ctx = _randn((B, M), 0, dtype, cuda_device)
    resid = _randn((B, D), 1, dtype, cuda_device, 2.0)
    wo = _randn((M, D), 2, dtype, cuda_device, M ** -0.5)
    bo = _randn((D,), 3, dtype, cuda_device) if bias else None
    scale = _randn((D,), 4, dtype, cuda_device) * 0.1 + 1
    nb = _randn((D,), 5, dtype, cuda_device)
    r, h = _counted(tdec.fused_proj_norm, ctx, resid, wo, bo, scale, nb,
                    kind=kind, eps=1e-5, parallel=parallel)
    wr, wh = tdec._proj_norm_ref(ctx, resid, wo, bo, scale, nb, kind=kind,
                                 eps=1e-5, parallel=parallel)
    _close(r, wr, GEMV_TOL[dtype])
    _close(h, wh, GEMV_TOL[dtype])
    # the last-block norm is ordered: the same inputs give the same bits
    r2, h2 = tdec.fused_proj_norm(ctx, resid, wo, bo, scale, nb, kind=kind,
                                  eps=1e-5, parallel=parallel)
    assert torch.equal(r, r2) and torch.equal(h, h2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,F,glu,bias,act", [
    (8, 4096, 14336, True, False, "silu"),      # llama3-8b decode
    (3, 256, 1024, False, True, "gelu"),
    (9, 128, 512, True, True, "gelu_exact"),
    (2, 64, 160, False, False, "relu")])
def test_fused_mlp_kernel_matches_plain(cuda_device, dtype, B, D, F, glu,
                                        bias, act):
    h = _randn((B, D), 0, dtype, cuda_device)
    r = _randn((B, D), 1, dtype, cuda_device)
    wu = _randn((D, F), 2, dtype, cuda_device, D ** -0.5)
    wd = _randn((F, D), 3, dtype, cuda_device, F ** -0.5)
    wg = _randn((D, F), 4, dtype, cuda_device, D ** -0.5) if glu else None
    bu = _randn((F,), 5, dtype, cuda_device) if bias else None
    bg = _randn((F,), 6, dtype, cuda_device) if (glu and bias) else None
    bd = _randn((D,), 7, dtype, cuda_device) if bias else None
    got = _counted(tdec.fused_mlp, h, r, wu, wd, wg, bu, bg, bd, act=act)
    want = tdec._mlp_ref(h, r, wu, wg, wd, bu, bg, bd, act=act)
    _close(got, want, GEMV_TOL[dtype])
    assert torch.equal(got, tdec.fused_mlp(h, r, wu, wd, wg, bu, bg, bd,
                                           act=act))


def _paged(B, Hkv, page, maxp, Dh, L, dtype, dev, seed):
    P = B * maxp + 1
    k = _randn((L, P, Hkv, page, Dh), seed, dtype, dev)
    v = _randn((L, P, Hkv, page, Dh), seed + 1, dtype, dev)
    perm = np.random.default_rng(seed).permutation(B * maxp) + 1
    table = torch.from_numpy(perm.reshape(B, maxp)).to(dev)
    return k, v, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,pos", [
    (256, [0, 254, 255, 256, 299, 300, 511, 1023]),   # llama3-8b pool
    (16, [0, 15, 16, 17, 255, 256, 300, 1023])])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_decode_kernel_matches_plain(cuda_device, dtype, page, pos,
                                           alibi):
    """The path shape (8 slots, 32/8 heads, Dh 128) over a stacked two-layer
    pool with a shuffled page table, depths at page boundaries."""
    B, H, Hkv, Dh, L = 8, 32, 8, 128, 2
    maxp = 1024 // page
    k, v, table = _paged(B, Hkv, page, maxp, Dh, L, dtype, cuda_device, 0)
    q = _randn((B, H, Dh), 9, dtype, cuda_device)
    posv = torch.tensor(pos, device=cuda_device)
    for layer in range(L):
        got = _counted(tdec.flash_decode, q, k, v, posv, layer=layer,
                       alibi=alibi, page_table=table)
        want = tdec._flash_decode_paged_ref(q, k, v, posv, table,
                                            scale=Dh ** -0.5, layer=layer,
                                            alibi=alibi)
        _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("Dh,H,Hkv,page", [(32, 4, 4, 16), (64, 12, 2, 64),
                                           (40, 6, 3, 8), (256, 16, 2, 32)])
def test_flash_decode_kernel_odd_shapes(cuda_device, Dh, H, Hkv, page):
    """Head dims below one warp's width and above, MHA and GQA groups of 2
    to 8, small pages, an unstacked pool (layer=None)."""
    B, maxp = 3, 6
    k, v, table = _paged(B, Hkv, page, maxp, Dh, 1, torch.float32,
                         cuda_device, 3)
    q = _randn((B, H, Dh), 4, torch.float32, cuda_device)
    posv = torch.tensor([0, page, page * maxp - 1], device=cuda_device)
    got = _counted(tdec.flash_decode, q, k[0], v[0], posv, page_table=table)
    want = tdec._flash_decode_paged_ref(q, k[0], v[0], posv, table,
                                        scale=Dh ** -0.5, layer=None,
                                        alibi=False)
    _close(got, want, ATTN_TOL[torch.float32])


def test_decode_kernels_refuse_bad_inputs(cuda_device):
    dev = cuda_device
    x = torch.ones(2, 64, device=dev)
    s = torch.ones(64, device=dev)
    w = torch.ones(64, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.fused_norm_qkv(x, s, None, w.t(), kind="rmsnorm")
    with pytest.raises(TypeError):
        tdec.fused_norm_qkv(x, s.bfloat16(), None, w, kind="rmsnorm")
    with pytest.raises(ValueError, match="multiple"):
        tdec.fused_norm_qkv(x, s, None, torch.ones(64, 62, device=dev),
                            kind="rmsnorm")
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_norm_qkv(x, s, None,
                            torch.ones(64 * 64 + 1, device=dev)[1:].view(64, 64),
                            kind="rmsnorm")
    with pytest.raises(ValueError, match="shape"):
        tdec.fused_proj_norm(x, torch.ones(2, 32, device=dev), w, None, s,
                             kind="rmsnorm")
    with pytest.raises(ValueError, match="activation"):
        tdec.fused_mlp(x, x, w, w, act="swish")
    with pytest.raises(ValueError):
        tdec.fused_norm_qkv(x, s, None, w, kind="batchnorm")
    q =torch.ones(2, 4, 64, device=dev)
    pool = torch.ones(3, 2, 16, 64, device=dev)
    pos = torch.tensor([1, 2], device=dev)
    table = torch.ones(2, 1, dtype=torch.long, device=dev)
    with pytest.raises(TypeError, match="int64"):
        tdec.flash_decode(q, pool, pool, pos.int(), page_table=table)
    with pytest.raises(TypeError, match="int64"):
        tdec.flash_decode(q, pool, pool, pos, page_table=table.int())
    with pytest.raises(ValueError, match="head dim"):
        tdec.flash_decode(torch.ones(2, 4, 60, device=dev),
                          torch.ones(3, 2, 16, 60, device=dev),
                          torch.ones(3, 2, 16, 60, device=dev), pos,
                          page_table=table)
    with pytest.raises(ValueError, match="GQA"):
        tdec.flash_decode(torch.ones(2, 32, 64, device=dev), pool[:, :2],
                          pool[:, :2].contiguous(), pos, page_table=table)
    with pytest.raises(ValueError, match="layer"):
        tdec.flash_decode(q, pool[None], pool[None], pos, layer=1,
                          page_table=table)


def test_serving_on_card_matches_cpu(cuda_device):
    """A small fp32 model served on the card (kernels) and on the CPU
    (plain versions): token-identical greedy outputs."""
    import deepspeed_tpu_torch

    over = dict(num_layers=2, hidden_size=128, intermediate_size=256,
                num_heads=4, num_kv_heads=2, vocab_size=512)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)       # spread the logits away from ties
    cfg = {"dtype": "float32", "use_fused_decode": False,
           "max_out_tokens": 64, "kv_page_tokens": 16}
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((23, 9, 40))]
    outs = []
    for dev in ("cpu", cuda_device):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=dev,
                                                 num_slots=2,
                                                 prefill_chunk=16)
        reqs = [serve.submit(p, max_new_tokens=12) for p in prompts]
        serve.run()
        serve.pool.check_no_leak()
        outs.append([r.output_tokens for r in reqs])
    assert outs[0] == outs[1]


def test_fused_serving_on_card_matches_cpu(cuda_device):
    """The default (fused) decode path: the small fp32 model on the card
    (the four decode kernels) and on the CPU (their plain versions) give
    the same greedy tokens, at 16-token pages."""
    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(num_layers=2, hidden_size=128, intermediate_size=256,
                num_heads=4, num_kv_heads=2, vocab_size=512)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)
    cfg = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16}
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((23, 9, 40))]
    outs = []
    for dev in ("cpu", cuda_device):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=dev,
                                                 num_slots=2,
                                                 prefill_chunk=16)
        assert serve.engine._dparams is not None
        before = tdec.fused_mlp.launches
        reqs = [serve.submit(p, max_new_tokens=12) for p in prompts]
        serve.run()
        serve.pool.check_no_leak()
        outs.append([r.output_tokens for r in reqs])
        if dev != "cpu":
            assert tdec.fused_mlp.launches > before
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    """Relative Frobenius error; absolute below a norm of 1 (a one-token
    causal row has p = 1 and zero dq, dk)."""
    return float((got.float() - want.float()).norm()
                 / max(float(want.float().norm()), 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 2048), (3, 5, 2048), (7, 100),
                                   (1, 64)])
def test_rms_norm_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    """llama-1b4's [micro * S, D] rows, a 3-D input, an odd row length (the
    element-by-element path) and a single row."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    dy = _randn(shape, 2, dtype, cuda_device)
    dx, dg = _counted(tln.rms_norm_bwd, x, g, dy, eps=1e-5)
    want_dx, want_dg = tln.rms_norm_bwd_plain(x, g, dy, eps=1e-5)
    assert dx.dtype == dtype and dg.dtype == dtype and dx.shape == x.shape
    _close(dx, want_dx, TOL[dtype])
    dg_tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_err(dg, want_dg) < dg_tol
    dx2, dg2 = tln.rms_norm_bwd(x, g, dy, eps=1e-5)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)   # no atomics


def test_rms_norm_autograd_launches_both_kernels(cuda_device):
    x = _randn((64, 256), 0, torch.bfloat16, cuda_device).requires_grad_()
    g = torch.ones(256, device=cuda_device, dtype=torch.bfloat16,
                   requires_grad=True)
    fwd, bwd = tln.rms_norm.launches, tln.rms_norm_bwd.launches
    tln.rms_norm(x, g, eps=1e-5).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tln.rms_norm.launches, tln.rms_norm_bwd.launches) == (fwd + 1,
                                                                  bwd + 1)
    want_dx, want_dg = tln.rms_norm_bwd_plain(
        x.detach(), g.detach(),
        2 * tln.rms_norm_plain(x.detach(), g.detach(), 1e-5).float()
        .to(torch.bfloat16), eps=1e-5)
    _close(x.grad, want_dx, 2e-2)
    assert _rel_err(g.grad, want_dg) < 2e-2


def _attn_inputs(B, H, S, D, dtype, dev, seed=0):
    return [_randn((B, H, S, D), seed + i, dtype, dev) for i in range(4)]


def _lse_plain(q, k, scale):
    S = q.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.logsumexp(logits.masked_fill(~mask, tfa.NEG_INF), -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,D", [(4, 16, 2048, 128),   # llama-1b4
                                     (2, 3, 200, 128),     # ragged S
                                     (1, 2, 64, 64), (1, 1, 1, 128)])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, B, H, S, D):
    """Forward (o and lse) against mha_reference, backward (dq, dk, dv)
    against autograd of mha_reference on the same inputs in fp32, and two
    backward calls give the same bits."""
    q, k, v, do = _attn_inputs(B, H, S, D, dtype, cuda_device)
    scale = D ** -0.5
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_fwd_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    want_o = tfa.mha_reference(q, k, v)
    _close(o, want_o, 2e-4 if dtype == torch.float32 else 2e-2)
    assert _rel_err(o, want_o) < (1e-5 if dtype == torch.float32 else 1e-2)
    _close(lse, _lse_plain(q, k, scale), 1e-4)
    grads = _counted(tfa.flash_attention_bwd, q, k, v, o, lse, do, True,
                     scale)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    tfa.mha_reference(*ref).backward(do.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, r, name in zip(grads, ref, "qkv"):
        assert got.dtype == dtype
        assert _rel_err(got, r.grad) < tol, name
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_flash_attention_autograd_and_refusals(cuda_device):
    q, k, v, do = _attn_inputs(1, 2, 128, 64, torch.bfloat16, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    tfa.flash_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
    assert all(t.grad is not None for t in leaves)
    with pytest.raises(ValueError, match="S == Sk"):
        tfa.flash_attention(q, k[:, :, :64].contiguous(), v[:, :, :64]
                            .contiguous())
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(q, k, v, alibi=True)


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,adam_w_mode", [(2048 * 5632, True),
                                           (1000003, False), (3, True),
                                           (1600, True)])   # a gpt2-xl norm leaf
def test_fused_adam_kernel_matches_plain(cuda_device, p_dtype, g_dtype, n,
                                         adam_w_mode):
    """Three steps in place from the same inputs: a llama-1b4 MLP leaf, an
    odd length (the scalar tail), and fewer elements than one vector."""
    p = _randn((n,), 0, p_dtype, cuda_device)
    m = torch.zeros(n, device=cuda_device)
    v = torch.zeros(n, device=cuda_device)
    state = [p.clone(), m.clone(), v.clone()]
    for step in (1, 2, 3):
        g = _randn((n,), step, g_dtype, cuda_device)
        kw = dict(lr=1e-3 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, adam_w_mode=adam_w_mode)
        _counted(tadam.fused_adam_update, p, g, m, v, step, **kw)
        tadam.fused_adam_update_plain(*state[:1], g, *state[1:], step, **kw)
    for got, want in zip((p, m, v), state):
        _close(got, want, 1e-6 if p_dtype == torch.float32 else 2e-2)


def test_training_on_card_matches_cpu(cuda_device):
    """A small fp32 model trained 3 steps on the card (kernels) and on the
    CPU (plain versions) from the same weights: losses within rtol 1e-4 and
    weights within atol 1e-4 (fp32 sums in another order; at lr 3e-4 Adam's
    normalised step keeps a weight difference near lr * 1e-2 even where a
    grad element sits near eps); every training kernel launched on the
    card."""
    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    over = dict(num_layers=2, hidden_size=128, intermediate_size=256,
                num_heads=2, num_kv_heads=1, vocab_size=512, remat=True,
                remat_policy="mlp_dots")
    tok = np.random.default_rng(0).integers(0, 512, (4, 96))
    runs = []
    counters = (tln.rms_norm, tln.rms_norm_bwd, trope.apply_rotary_pos_emb,
                tfa.flash_attention, tfa.flash_attention_bwd,
                tadam.fused_adam_update)
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        before = [c.launches for c in counters]
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        after = [c.launches for c in counters]
        assert all(b < a for b, a in zip(before, after)) == (dev != "cpu")
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lg[-1] < lg[0]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# LayerNorm, softmax, bias_act (the gpt2 family)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 1600), (8, 1600), (64, 768),
                                   (7, 40), (13, 2048), (5, 100),
                                   (3, 5, 4096)])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, shape):
    """gpt2-xl's training rows and decode rows, gpt2-small's width, a row
    shorter than a warp's vectors and a ragged row count (one warp per
    row), then the block-per-row path: a row length that is no multiple of
    the vector, and one longer than a warp holds."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0) + 1.5
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    b = _randn(shape[-1:], 2, dtype, cuda_device) * 0.1
    got = _counted(tln.layer_norm, x, g, b, eps=1e-5)
    want = tln.layer_norm_plain(x, g, b, eps=1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 1600), (3, 5, 768), (7, 100),
                                   (1, 64), (600, 6144)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    """gpt2-xl's [micro * S, D] rows, a 3-D input, an odd row length (the
    element-by-element path), a single row, and the longest row the kernel
    takes (48 KB of partials: more than a block's default shared memory)."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0) + 1.5
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    dy = _randn(shape, 2, dtype, cuda_device)
    dx, dg, db = _counted(tln.layer_norm_bwd, x, g, dy, eps=1e-5)
    want_dx, want_dg, want_db = tln.layer_norm_bwd_plain(x, g, dy, eps=1e-5)
    assert dx.dtype == dg.dtype == db.dtype == dtype and dx.shape == x.shape
    assert dg.shape == db.shape == g.shape
    _close(dx, want_dx, TOL[dtype])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_err(dg, want_dg) < tol and _rel_err(db, want_db) < tol
    again = tln.layer_norm_bwd(x, g, dy, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))


def test_layer_norm_autograd_and_refusals(cuda_device):
    dev = cuda_device
    x = _randn((64, 256), 0, torch.bfloat16, dev).requires_grad_()
    g = torch.ones(256, device=dev, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(256, device=dev, dtype=torch.bfloat16, requires_grad=True)
    fwd, bwd = tln.layer_norm.launches, tln.layer_norm_bwd.launches
    tln.layer_norm(x, g, b, eps=1e-5).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tln.layer_norm.launches, tln.layer_norm_bwd.launches) == (fwd + 1,
                                                                      bwd + 1)
    y = tln.layer_norm_plain(x.detach(), g.detach(), b.detach(), 1e-5)
    want = tln.layer_norm_bwd_plain(x.detach(), g.detach(),
                                    (2 * y.float()).to(torch.bfloat16), 1e-5)
    _close(x.grad, want[0], 2e-2)
    assert _rel_err(g.grad, want[1]) < 2e-2 and _rel_err(b.grad, want[2]) < 2e-2
    x32 = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError):
        tln.layer_norm(x32.t(), torch.ones(4, device=dev),
                       torch.ones(4, device=dev))
    with pytest.raises(TypeError):
        tln.layer_norm(x32, torch.ones(64, device=dev, dtype=torch.bfloat16),
                       torch.ones(64, device=dev))
    with pytest.raises(ValueError):
        tln.layer_norm(x32, torch.ones(64, device=dev),
                       torch.ones(32, device=dev))
    wide = torch.ones(2, 6152, device=dev)
    with pytest.raises(ValueError, match="6144"):
        tln.layer_norm_bwd(wide, torch.ones(6152, device=dev), wide)


def test_rms_norm_bwd_kernel_takes_its_longest_row(cuda_device):
    """n = 12288 is 48 KB of dγ partials beside the reduction scratch: more
    than a block's default shared memory, which the launch opts in to."""
    x = _randn((300, 12288), 0, torch.bfloat16, cuda_device, 3.0)
    g = _randn((12288,), 1, torch.bfloat16, cuda_device) * 0.1 + 1
    dy = _randn((300, 12288), 2, torch.bfloat16, cuda_device)
    dx, dg = tln.rms_norm_bwd(x, g, dy, eps=1e-5)
    torch.cuda.synchronize()
    want_dx, want_dg = tln.rms_norm_bwd_plain(x, g, dy, eps=1e-5)
    _close(dx, want_dx, 2e-2)
    assert _rel_err(dg, want_dg) < 2e-2


def _softmax_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,mask", [
    ((4, 25, 1024, 1024), None), ((4, 25, 1024, 1024), "causal"),
    ((2, 3, 50, 1000), "padding"), ((37, 100), "full"), ((5,), None),
    ((2, 2, 3, 4, 100), "deep"), ((3, 8192), None)])
def test_softmax_kernel_matches_plain(cuda_device, dtype, shape, mask):
    """gpt2-xl's attention scores with and without a causal [S, S] bool
    mask read through its strides; a row length that is no power of two
    under a [B, 1, 1, n] padding mask; a mask of x's shape with a fully
    masked row; a 1-D input; a 5-D input (the mask is broadcast and
    copied); a row of two 4096-wide tiles."""
    dev = cuda_device
    x = _randn(shape, 0, dtype, dev, 4.0)
    n = shape[-1]
    rng = np.random.default_rng(1)
    m = None
    if mask == "causal":
        m = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    elif mask == "padding":
        m = torch.ones(shape[0], 1, 1, n, dtype=torch.int32, device=dev)
        m[1, ..., 700:] = 0
    elif mask == "full":
        m = torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32)).to(dev)
        m[3] = 0
    elif mask == "deep":
        m = torch.from_numpy(rng.integers(0, 2, (3, 1, n)).astype(np.int64)).to(dev)
    got = _counted(tsm.scaled_masked_softmax, x, m, scale=0.125)
    want = tsm.scaled_masked_softmax_plain(x, m, scale=0.125)
    assert got.dtype == dtype and got.shape == x.shape
    _softmax_close(got, want, dtype)
    if mask == "full":
        torch.testing.assert_close(got[3].float(),
                                   torch.full((n,), 1 / n, device=dev),
                                   rtol=8e-3, atol=0)
    if mask == "causal":
        assert float(got[..., ~m].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "identity"])
@pytest.mark.parametrize("shape", [(8192, 6400), (3, 7, 100)])
def test_bias_act_kernel_matches_plain(cuda_device, dtype, act, shape):
    """gpt2-xl's [micro * S, F] MLP activations, and an odd shape whose
    last block is ragged."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    b = _randn(shape[-1:], 1, dtype, cuda_device)
    got = _counted(tsm.bias_act, x, b, act)
    want = tsm.bias_act_plain(x, b, act)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, TOL[dtype])


def test_softmax_and_bias_act_refuse_bad_inputs(cuda_device):
    dev = cuda_device
    x = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tsm.scaled_masked_softmax(x.t())
    with pytest.raises(ValueError, match="16384"):
        tsm.scaled_masked_softmax(torch.ones(2, 16385, device=dev))
    with pytest.raises(RuntimeError):
        tsm.scaled_masked_softmax(x, torch.ones(3, 64, device=dev))
    with pytest.raises(ValueError, match="expected a tensor on"):
        tsm.scaled_masked_softmax(x, torch.ones(4, 64))
    with pytest.raises(TypeError):
        tsm.scaled_masked_softmax(x.long())
    with pytest.raises(ValueError, match="bias shape"):
        tsm.bias_act(x, torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        tsm.bias_act(x.t(), torch.ones(4, device=dev))


GPT2_SMALL = dict(num_layers=2, hidden_size=128, intermediate_size=512,
                  num_heads=2, vocab_size=512, max_seq_len=128)


@pytest.mark.parametrize("fused", [True, False])
def test_gpt2_serving_on_card_matches_cpu(cuda_device, fused):
    """A small fp32 gpt2-shaped model (learned positions, LayerNorm with
    biases, GeLU, no gate, heads of 64) served on the card and on the CPU:
    the same greedy tokens on both decode paths; the card run launches the
    LayerNorm kernel and no RoPE."""
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm("gpt2-small", device="cpu",
                                          **GPT2_SMALL)
    with torch.no_grad():
        model.embed.tok.mul_(16.0)       # spread the logits away from ties,
        model.embed.pos.mul_(80.0)       # and keep the outputs varied
    cfg = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16}
    if not fused:
        cfg["use_fused_decode"] = False
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((23, 9, 40))]
    outs = []
    for dev in ("cpu", cuda_device):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=dev,
                                                 num_slots=2, prefill_chunk=16)
        assert (serve.engine._dparams is not None) is fused
        ln, rope = tln.layer_norm.launches, trope.apply_rotary_pos_emb.launches
        reqs = [serve.submit(p, max_new_tokens=12) for p in prompts]
        serve.run()
        serve.pool.check_no_leak()
        outs.append([r.output_tokens for r in reqs])
        assert (tln.layer_norm.launches > ln) == (dev != "cpu")
        assert trope.apply_rotary_pos_emb.launches == rope
    assert outs[0] == outs[1]


@pytest.mark.parametrize("fused", [True, False])
def test_gpt2_window_past_the_position_table_on_card(cuda_device, fused):
    """A KV window (64) larger than the learned position table (40 rows):
    the padded chunk of a 35-token prompt and the parked slot read clamped
    rows instead of faulting, the tokens equal the CPU run's, and a request
    that reaches the table's end stops with ``cache_budget``."""
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm(
        "gpt2-small", device="cpu", **dict(GPT2_SMALL, max_seq_len=40))
    with torch.no_grad():
        model.embed.tok.mul_(16.0)
        model.embed.pos.mul_(80.0)
    cfg = {"dtype": "float32", "max_out_tokens": 64, "kv_page_tokens": 16}
    if not fused:
        cfg["use_fused_decode"] = False
    rng = np.random.default_rng(1)
    asks = [(rng.integers(0, 512, 35), 3), (rng.integers(0, 512, 20), 30)]
    outs = []
    for dev in ("cpu", cuda_device):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=dev,
                                                 num_slots=2, prefill_chunk=16)
        reqs = [serve.submit(p, max_new_tokens=n) for p, n in asks]
        serve.run()
        torch.cuda.synchronize()
        outs.append([(r.output_tokens, r.finish_reason) for r in reqs])
    assert outs[0] == outs[1]
    assert outs[1][0][1] == "length" and len(outs[1][0][0]) == 3
    assert outs[1][1][1] == "cache_budget" and len(outs[1][1][0]) == 20


def test_gpt2_training_on_card_matches_cpu(cuda_device):
    """The small fp32 gpt2-shaped model under the gpt2-xl preset's full
    remat, trained 3 steps on the card and on the CPU from the same
    weights: losses within rtol 1e-4, weights within atol 1e-4; LayerNorm
    forward and backward, flash attention and Adam launch on the card, RoPE
    and RMSNorm do not."""
    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    tok = np.random.default_rng(0).integers(0, 512, (4, 96))
    runs = []
    used = (tln.layer_norm, tln.layer_norm_bwd, tfa.flash_attention,
            tfa.flash_attention_bwd, tadam.fused_adam_update)
    unused = (tln.rms_norm, tln.rms_norm_bwd, trope.apply_rotary_pos_emb)
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("gpt2-small", device="cpu",
                                              remat=True, **GPT2_SMALL)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        before = [c.launches for c in used + unused]
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        moved = [c.launches > b for c, b in zip(used + unused, before)]
        assert moved == [dev != "cpu"] * len(used) + [False] * len(unused)
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lg[-1] < lg[0]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_gpt2_xl_training_kernels_follow_plain_versions(cuda_device, monkeypatch):
    """gpt2-xl at full width and depth, bf16, 5 steps on one repeated batch
    (micro 8 x gas 2 x S 1024): the run on the kernels and a run with every
    training wrapper forced onto its plain version on the card give the
    same loss at every step within 1e-3 relative (bf16 compute; measured
    2e-5).  The loss is not monotonic here (it overshoots at the first
    full-lr step): this shows that the optimizer's path, not a kernel,
    takes it there.  Needs ~30 GB of device memory and about a minute."""
    import gc

    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2,
           "bf16": {"enabled": True},
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    runs = []
    for plain in (False, True):
        if plain:
            for mod in (tln, trope, tfa, tadam):
                monkeypatch.setattr(mod, "use_kernel", lambda t: False)
        model = deepspeed_tpu_torch.causal_lm("gpt2-xl", seed=0)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        tok = torch.randint(0, 50257, (16, 1024), device=cuda_device,
                            generator=gen)
        before = tln.layer_norm.launches
        runs.append([float(engine.train_step((tok, tok))) for _ in range(5)])
        assert (tln.layer_norm.launches > before) == (not plain)
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()
    print(f"gpt2-xl losses, kernels {runs[0]} vs plain versions {runs[1]}")
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-3)
    assert runs[0][-1] < runs[0][0]


# ---------------------------------------------------------------------------
# the block quantizer, Adam8bit and LAMB: every operation of the three
# kernels is written with its IEEE-rounded intrinsic (no FMA contraction),
# so codes, scales, moments and the stochastically rounded params must
# EQUAL the plain versions'; LAMB's p is within 1e-5 relative (its norms
# are summed in another order than torch.linalg.vector_norm's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [((24 * 2048 * 5632 // 64,), 2048),
                                         ((1000003,), 128), ((3, 7, 131), 512),
                                         ((70000,), 1 << 16), ((5000,), 384)])
def test_quantize_kernel_matches_plain(cuda_device, dtype, bits, shape, block):
    from deepspeed_tpu_torch.ops.kernels import quantizer as tq

    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    x.view(-1)[:block] = 0                            # an all-zero block
    before = tq.quantize.launches
    q, s, pad = tq.quantize(x, bits=bits, block=block)
    torch.cuda.synchronize()
    assert tq.quantize.launches == before + 1
    wq, ws, wpad = tq.quantize_plain(x, bits=bits, block=block)
    assert pad == wpad and q.shape == wq.shape
    assert torch.equal(q, wq) and torch.equal(s, ws)
    # a view one element in: the kernel's element-by-element path
    q2, s2, _ = tq.quantize(x.view(-1)[1:], bits=bits, block=block)
    w2, ws2, _ = tq.quantize_plain(x.view(-1)[1:], bits=bits, block=block)
    assert torch.equal(q2, w2) and torch.equal(s2, ws2)


def _adam8bit_case(dev, n, block, p_dtype, seed):
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as t8

    rows = t8.state_rows(n, block)
    p = _randn((n,), seed, torch.float32, dev).to(p_dtype)
    mq = torch.zeros(rows, block, dtype=torch.int8, device=dev)
    state = [mq, torch.ones(rows, 1, device=dev), mq.clone(),
             torch.ones(rows, 1, device=dev)]
    return p, state


@pytest.mark.parametrize("p_dtype,g_dtype,sr", [
    (torch.bfloat16, torch.bfloat16, True), (torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, False), (torch.float32, torch.float32, False),
    (torch.float32, torch.bfloat16, False)])
@pytest.mark.parametrize("n,block", [(24 * 2048 * 5632 // 16, 512),
                                     (1000003, 128), (77777, 4096), (4096, 1024)])
def test_fused_adam8bit_kernel_matches_plain(cuda_device, p_dtype, g_dtype, sr,
                                             n, block):
    """Three steps from zero state; n ragged (neither a multiple of the
    block nor filling 32 rows) or not; the largest block; bf16 params with
    and without stochastic rounding, fp32 params (never rounded)."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as t8

    p, st = _adam8bit_case(cuda_device, n, block, p_dtype, 0)
    rp, rst = p.clone(), [t.clone() for t in st]
    before = t8.fused_adam8bit_update.launches
    for step in (1, 2, 3):
        g = _randn((n,), step, g_dtype, cuda_device, 1e-2)
        kw = dict(lr=1e-3 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=0.1, seed=t8.sr_seed(step, 4), sr=sr)
        t8.fused_adam8bit_update(p, g, *st, step, **kw)
        t8.fused_adam8bit_update_plain(rp, g, *rst, step, **kw)
    torch.cuda.synchronize()
    assert t8.fused_adam8bit_update.launches == before + 3
    assert torch.equal(p, rp)
    for a, b in zip(st, rst):
        assert torch.equal(a, b)


def test_fused_adam8bit_in_place_contract_and_sr_repeats(cuda_device):
    """No write past n; rows wholly past n keep codes 0 and scales 1; the
    same seed gives the same bits twice, another seed other bits; the
    kernel's hash is the plain version's."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as t8

    n, block = 1000, 128
    buf = torch.full((n + 64,), 7.0, device=cuda_device, dtype=torch.bfloat16)
    outs = []
    for seed in (5, 5, 6):
        buf[:n] = _randn((n,), 0, torch.bfloat16, cuda_device)
        _, st = _adam8bit_case(cuda_device, n, block, torch.bfloat16, 0)
        t8.fused_adam8bit_update(buf[:n], _randn((n,), 1, torch.float32, cuda_device),
                                 *st, 1, lr=1e-3, seed=seed, sr=True)
        torch.cuda.synchronize()
        assert bool((buf[n:] == 7.0).all())
        assert bool((st[1][8:] == 1).all() and (st[3][8:] == 1).all())
        assert int(st[0][8:].abs().max()) == 0 and int(st[0][7, n - 7 * block:].abs().max()) == 0
        outs.append(buf[:n].clone())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    lib = t8._library().lib
    xs = [0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF, 12345]
    assert [lib.ds_mix32(x) for x in xs] == [t8.mix32_int(x) for x in xs]
    with pytest.raises(ValueError, match="power of two"):
        t8.check_block(8192)


@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,wd", [(24 * 2048 * 5632 // 16, 0.1), (1000003, 0.0),
                                  (4099, 0.01)])
def test_fused_lamb_kernels_match_plain(cuda_device, p_dtype, g_dtype, n, wd):
    """Three steps; the moments equal, p within 1e-5 relative, the norms'
    stats within 1e-5 relative and bit-equal on a repeat."""
    from deepspeed_tpu_torch.ops.kernels import fused_lamb as tl

    p = _randn((n,), 0, torch.float32, cuda_device).to(p_dtype)
    m, v = (torch.zeros(n, device=cuda_device) for _ in range(2))
    rp, rm, rv = p.clone(), m.clone(), v.clone()
    before = (tl.lamb_phase1.launches, tl.lamb_scale.launches)
    for step in (1, 2, 3):
        g = _randn((n,), step, g_dtype, cuda_device, 1e-2)
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=wd)
        m0, v0 = m.clone(), v.clone()
        stats = tl.lamb_phase1(p, g, m, v, step, lr=1e-3 * step, **kw)
        again = tl.lamb_phase1(p, g, m0, v0, step, lr=1e-3 * step, **kw)
        tl.lamb_scale(p, m, v, stats, step, **kw)
        want = tl.lamb_phase1_plain(rp, g, rm, rv, step, lr=1e-3 * step, **kw)
        tl.lamb_scale_plain(rp, rm, rv, want, step, **kw)
        torch.cuda.synchronize()
        assert torch.equal(stats, again)
        torch.testing.assert_close(stats, want, rtol=1e-5, atol=0)
    assert (tl.lamb_phase1.launches, tl.lamb_scale.launches) == (before[0] + 6,
                                                                 before[1] + 3)
    assert torch.equal(m, rm) and torch.equal(v, rv)
    tol = 1e-5 if p_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(p.float(), rp.float(), rtol=tol, atol=tol)
