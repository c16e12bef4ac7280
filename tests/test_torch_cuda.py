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
(exp-based GeLU and SiLU against tanh and sigmoid) / 2e-2 bf16.  fp16 (the
norms, RoPE, flash attention and fused Adam, for ``fp16.enabled``
training): each bf16 bound over 8, as fp16 keeps three more mantissa bits
(2^-11 against 2^-8 relative): 2.5e-3 elementwise and for the flash
gradients, 1.25e-3 for the flash output's relative error.
"""

import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import decode as tdec
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels import fused_adam as tadam
from deepspeed_tpu_torch.ops.kernels import layer_norm as tln
from deepspeed_tpu_torch.ops.kernels import rope as trope
from deepspeed_tpu_torch.ops.kernels import softmax as tsm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
# fp16 GEMVs: the bf16 bound over 8, as the other fp16 bounds.  fp16 rounds
# at 2^-11 relative, so an output differs from the plain version by about
# one fp16 ulp (at most 2^-10 relative) where the two fp32 sums straddle a
# rounding boundary, and the normalised rows rounded to fp16 before the
# product move a sum by less; rtol 2.5e-3 is about 2.5 ulps.
GEMV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
# the flash output's relative Frobenius error, and the gradients'
O_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1.25e-3}
GRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]

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


# the forwards' row counts: one row, decode (8 slots), a prefill chunk (64),
# one past a wave of 132 SMs, generate()'s prefill (8 x 200), a count that
# does not divide into the streaming blocks' warps, the training rows; and
# widths: gpt2-xl's, llama-1b4's and bloom-1b7's, llama3-8b's
_NORM_ROWS = (1, 8, 64, 133, 1600, 4099, 8192)
_NORM_WIDTHS = (1600, 2048, 4096)
_NORM_SHAPES = [(r, n) for r in _NORM_ROWS for n in _NORM_WIDTHS]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 4096), (64, 4096), (8192, 2048),
                                   (3, 5, 4096), (7, 100)]
                         + [s for s in _NORM_SHAPES
                            if s not in ((8, 4096), (64, 4096), (8192, 2048))]
                         + [(3, 20000), (5, 4100), (1, 8)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, shape):
    """Path shapes (decode rows = num_slots, prefill rows = chunk, llama-1b4
    training rows = micro * S), every row count of _NORM_ROWS at every width
    of _NORM_WIDTHS (a block of warps a row), an odd row length (the
    element-by-element path), rows past 16 warps' registers (20000) and
    4100, which is 16-byte vectors in fp32 only; a second call gives the
    same bits."""
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
    assert torch.equal(got, tln.rms_norm(x, g, eps=1e-5))


def test_rms_norm_kernel_refuses_bad_inputs(cuda_device):
    x = torch.ones(4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tln.rms_norm(x.t(), torch.ones(4, device=cuda_device))
    with pytest.raises(TypeError):
        tln.rms_norm(x, torch.ones(64, device=cuda_device,
                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tln.rms_norm(x, torch.ones(32, device=cuda_device))


def test_rms_norm_lean_path_keeps_every_refusal(cuda_device):
    """The one-pass attribute test of the lean host path falls back on the
    shared checks, so each refusal raises what it raised before: a
    non-contiguous x or gamma, a gamma of another dtype or shape, a gamma
    on the CPU beside a CUDA x, an x of no kernel dtype."""
    x = torch.ones(4, 64, device=cuda_device, dtype=torch.bfloat16)
    g = torch.ones(64, device=cuda_device, dtype=torch.bfloat16)
    before = tln.rms_norm.launches
    with pytest.raises(ValueError, match="contiguous"):
        tln.rms_norm(torch.ones(64, 4, device=cuda_device,
                                dtype=torch.bfloat16).t(), g)
    with pytest.raises(ValueError, match="contiguous"):
        tln.rms_norm(x, torch.ones(64, 2, device=cuda_device,
                                   dtype=torch.bfloat16)[:, 0])
    with pytest.raises(TypeError, match="expected dtype"):
        tln.rms_norm(x, g.float())
    with pytest.raises(ValueError, match="gamma shape"):
        tln.rms_norm(x, torch.ones(65, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected a tensor on"):
        tln.rms_norm(x, g.cpu())
    with pytest.raises(TypeError, match="not supported"):
        tln.rms_norm(x.to(torch.int32), g.to(torch.int32))
    assert tln.rms_norm.launches == before


def test_rms_norm_launches_on_the_current_stream(cuda_device):
    """Under torch.cuda.stream(s) the kernel goes to s: behind a long sleep
    on s, x is written on s and normalised on s, so the output recorded on
    s holds x's norm (on another stream the kernel would have read the
    zeros that x held before)."""
    src = _randn((8, 4096), 0, torch.bfloat16, cuda_device, 3.0)
    g = _randn((4096,), 1, torch.bfloat16, cuda_device) * 0.1 + 1
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        x.copy_(src)
        y = _counted(tln.rms_norm, x, g, eps=1e-5)
        done = s.record_event()
    done.synchronize()
    torch.testing.assert_close(y.float(), tln.rms_norm_plain(src, g, 1e-5).float(),
                               rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


def _rope_tables(pos, rd, dtype, dev, theta=500000.0):
    cos, sin = trope.rope_angles(pos.reshape(-1).to(dev), rd, theta=theta)
    shape = tuple(pos.shape) + (rd // 2,)
    return cos.reshape(shape).to(dtype), sin.reshape(shape).to(dtype)


def _equal(got, want):
    """The RoPE kernel rounds each product, difference and sum as the plain
    version's separate operations do: the same bits."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w), float((g.float() - w.float()).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 32, 64, 128), (1, 8, 64, 128),
                                   (4, 16, 2048, 128), (1, 32, 17, 128),
                                   (2, 3, 5, 48)])
@pytest.mark.parametrize("view", [False, True])
def test_rope_kernel_matches_plain(cuda_device, dtype, shape, view):
    """``apply_rotary_pos_emb`` on x [B, H, S, D], contiguous or as the
    [B, H, S, D] view of a [B, S, H, D] tensor (read in place): one launch,
    bit-equal to ``rope_plain``, and to a second call."""
    B, H, S, D = shape
    x = _randn((B, S, H, D) if view else shape, 2, dtype, cuda_device)
    if view:
        x = x.transpose(1, 2)
    cos, sin = _rope_tables(torch.arange(100, 100 + S), D, dtype, cuda_device)
    got = _counted(trope.apply_rotary_pos_emb, x, cos, sin)
    _equal((got, trope.apply_rotary_pos_emb(x, cos, sin)),
           (trope.rope_plain(x, cos, sin),) * 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_backward_is_the_kernel_with_negated_sin(cuda_device, dtype):
    """llama-1b4's training q: the backward is one launch of the same
    kernel with its sign flag, bit-equal to the plain version with -sin."""
    x = _randn((4, 16, 2048, 128), 3, dtype, cuda_device).requires_grad_()
    dy = _randn((4, 16, 2048, 128), 4, dtype, cuda_device)
    cos, sin = _rope_tables(torch.arange(2048), 128, dtype, cuda_device, 10000.0)
    before = trope.apply_rotary_pos_emb.launches
    trope.apply_rotary_pos_emb(x, cos, sin).backward(dy)
    torch.cuda.synchronize()
    assert trope.apply_rotary_pos_emb.launches == before + 2
    _equal((x.grad,), (trope.rope_plain(dy, cos, -sin),))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("table", ["x", "float32"])
@pytest.mark.parametrize("B,S,H,Hkv,D,rd", [
    (1, 64, 32, 8, 128, 128),       # llama3-8b's serve prefill chunk
    (4, 2048, 16, 16, 128, 128),    # llama-1b4's training q and k
    (2, 33, 8, 4, 32, 32),          # llama-tiny's heads
    (2, 9, 4, 4, 128, 32),          # gpt-neox rotary_pct 0.25
    (3, 5, 3, 1, 48, 24),           # element by element
])
def test_rope_qk_forward_and_backward_match_plain(cuda_device, dtype, table, B, S,
                                                  H, Hkv, D, rd):
    """``rope_qk`` from the projections' [B, S, Hx, D] views: one launch
    forward (contiguous [B, Hx, S, D] out) and one backward (dq and dk in
    the projections' layout), each bit-equal to its plain version; tables
    in x's dtype or fp32, one table or per-row tables."""
    tdt = dtype if table == "x" else torch.float32
    q = _randn((B, S, H * D), 5, dtype, cuda_device).view(B, S, H, D).requires_grad_()
    k = _randn((B, S, Hkv * D), 6, dtype, cuda_device).view(B, S, Hkv, D).requires_grad_()
    dq = _randn((B, H, S, D), 7, dtype, cuda_device)
    dk = _randn((B, Hkv, S, D), 8, dtype, cuda_device)
    for per_row in (False, True):
        pos = (torch.randint(0, 8000, (B, S), generator=torch.Generator().manual_seed(0))
               if per_row else torch.arange(3, 3 + S))
        cos, sin = _rope_tables(pos, rd, tdt, cuda_device)
        q.grad = k.grad = None
        before = trope.apply_rotary_pos_emb.launches
        gq, gk = trope.rope_qk(q, k, cos, sin)
        torch.autograd.backward((gq, gk), (dq, dk))
        torch.cuda.synchronize()
        assert trope.apply_rotary_pos_emb.launches == before + 2
        _equal((gq, gk), trope.rope_qk_plain(q.detach(), k.detach(), cos, sin))
        plain = trope.rope_rows_plain if per_row else trope.partial_rope_plain
        _equal((q.grad, k.grad), tuple(plain(g, cos, -sin).transpose(1, 2).contiguous()
                                       for g in (dq, dk)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B,H,Hkv,D,rd", [(8, 32, 8, 128, 128), (1, 32, 8, 128, 128),
                                          (3, 4, 2, 64, 16), (2, 3, 1, 48, 24)])
def test_rope_qkv_rows_matches_plain(cuda_device, dtype, per_row, B, H, Hkv, D, rd):
    """The fused decode's form on [B, (H + 2 Hkv) D] QKV rows with fp32
    tables at one scalar position or at each row's own: one launch, q
    contiguous, both bit-equal to the plain version and to a second
    call."""
    qkv = _randn((B, (H + 2 * Hkv) * D), 9, dtype, cuda_device)
    pos = torch.arange(B) * 211 + 5 if per_row else torch.tensor([77])
    cos, sin = _rope_tables(pos, rd, torch.float32, cuda_device)
    before = trope.apply_rotary_pos_emb.launches
    got = trope.rope_qkv_rows(qkv, cos, sin, H, Hkv, D)
    torch.cuda.synchronize()
    assert trope.apply_rotary_pos_emb.launches == before + 1
    wq, wk = trope.rope_qkv_rows_plain(qkv, cos, sin, H, Hkv, D)
    _equal(got + trope.rope_qkv_rows(qkv, cos, sin, H, Hkv, D), (wq, wk.contiguous()) * 2)


def test_rope_kernel_refuses_bad_inputs(cuda_device):
    """A strided view is taken (the kernel reads strides); a last dim that
    is not contiguous, an odd rotated width, tables wider than the head,
    another dtype or device, and cos and sin laid out apart are refused,
    each before any launch."""
    dev = cuda_device
    x = torch.ones(1, 4, 2, 8, device=dev).transpose(1, 2)      # [1, 2, 4, 8] view
    cos, sin = torch.ones(4, 4, device=dev), torch.zeros(4, 4, device=dev)
    _equal((_counted(trope.apply_rotary_pos_emb, x, cos, sin),),
           (trope.rope_plain(x, cos, sin),))
    before = trope.apply_rotary_pos_emb.launches
    x = torch.ones(1, 2, 4, 8, device=dev)       # [B, H, S, D]
    q = torch.ones(1, 4, 2, 8, device=dev)       # [B, S, H, D]
    refused = [
        (ValueError, lambda: trope.apply_rotary_pos_emb(
            torch.ones(1, 2, 8, 4, device=dev).transpose(2, 3), cos, sin)),
        (ValueError, lambda: trope.apply_rotary_pos_emb(
            torch.ones(1, 2, 4, 7, device=dev), cos[:, :3], sin[:, :3])),
        (ValueError, lambda: trope.partial_rope(x, torch.ones(4, 5, device=dev),
                                                torch.ones(4, 5, device=dev))),
        (ValueError, lambda: trope.partial_rope(x, cos[:3], sin[:3])),
        (TypeError, lambda: trope.partial_rope(x.double(), cos, sin)),
        (TypeError, lambda: trope.partial_rope(x.half(), cos.bfloat16(), sin.bfloat16())),
        (TypeError, lambda: trope.partial_rope(x, cos, sin.half())),
        (ValueError, lambda: trope.partial_rope(x, cos.cpu(), sin.cpu())),
        (ValueError, lambda: trope.partial_rope(x, cos, torch.zeros(4, 8, device=dev)[:, ::2])),
        (ValueError, lambda: trope.rope_qk(q, q[..., :4], cos, sin)),
        (ValueError, lambda: trope.rope_qk(
            q, torch.ones(1, 4, 8, 2, device=dev).transpose(2, 3), cos, sin)),
        (ValueError, lambda: trope.rope_qk(q, q, cos[None].expand(2, 4, 4),
                                           sin[None].expand(2, 4, 4))),
        (ValueError, lambda: trope.rope_qkv_rows(torch.ones(2, 40, device=dev), cos[:1],
                                                 sin[:1], 4, 2, 8)),
        (ValueError, lambda: trope.rope_qkv_rows(torch.ones(2, 64, device=dev), cos[:3],
                                                 sin[:3], 4, 2, 8)),
        (ValueError, lambda: trope.rope_qkv_rows(torch.ones(2, 64, device=dev)[:, ::2],
                                                 cos[:1], sin[:1], 2, 1, 8)),
    ]
    for err, call in refused:
        with pytest.raises(err):
            call()
    assert trope.apply_rotary_pos_emb.launches == before


def test_rope_launches_on_the_current_stream(cuda_device):
    """The decode rows are rotated on the caller's stream: the QKV rows are
    written on s behind a sleep and rotated on s, so the output recorded on
    s holds the rotation of those rows."""
    src = _randn((8, 48 * 128), 0, torch.bfloat16, cuda_device)
    cos, sin = _rope_tables(torch.arange(8) * 9, 128, torch.float32, cuda_device)
    qkv = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        qkv.copy_(src)
        q, k = trope.rope_qkv_rows(qkv, cos, sin, 32, 8, 128)
        done = s.record_event()
    done.synchronize()
    wq, wk = trope.rope_qkv_rows_plain(src, cos, sin, 32, 8, 128)
    _equal((q, k), (wq, wk.contiguous()))


@pytest.mark.parametrize("path", ["generate", "serve"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_decode_paths_launch_one_rope_a_layer(cuda_device, path, fused, rotary_pct):
    """A small fp32 llama-shaped model (and a quarter of each head rotated,
    gpt-neox's rotary_pct) through ``generate()`` (a scalar position) and
    ``init_serving`` (paged, per-row positions), fused and unfused decode:
    one RoPE launch a layer on each prefill forward and each decode step,
    and the same greedy tokens as the CPU run."""
    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    model = deepspeed_tpu_torch.causal_lm(
        "llama-tiny", device="cpu", num_layers=2, hidden_size=256,
        intermediate_size=512, num_kv_heads=2, vocab_size=1024, rotary_pct=rotary_pct)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)
    L = model.config.num_layers
    cfg = {"dtype": "float32", "max_out_tokens": 300}
    if not fused:
        cfg["use_fused_decode"] = False
    prompts = np.random.default_rng(0).integers(0, 1024, (3, 70))
    outs = []
    for dev in ("cpu", cuda_device):
        before = trope.apply_rotary_pos_emb.launches
        if path == "generate":
            eng = deepspeed_tpu_torch.init_inference(model, cfg, device=dev)
            outs.append(eng.generate(prompts, max_new_tokens=12).cpu())
            want = L * 12           # the prefill and 11 decode forwards
        else:
            serve = deepspeed_tpu_torch.init_serving(
                model, dict(cfg, kv_page_tokens=16), device=dev, num_slots=2,
                prefill_chunk=16)
            reqs = [serve.submit(p, max_new_tokens=10) for p in prompts]
            serve.run()
            outs.append([r.output_tokens for r in reqs])
            st = serve.stats
            want = L * (st["prefill_chunks"] + st["decode_blocks"] * serve._K)
        torch.cuda.synchronize()
        got = trope.apply_rotary_pos_emb.launches - before
        assert got == (want if dev != "cpu" else 0)
    if path == "generate":
        assert torch.equal(outs[0], outs[1])
    else:
        assert outs[0] == outs[1]


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _within_f16_ulp(got, want):
    """fp16 got within one fp16 ulp of want in every element."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 11)
    ulp = torch.where(w == 0, 2.0 ** -24, ulp.clamp_min(2.0 ** -24))
    assert float(((got.float() - w).abs() / ulp).max()) <= 1


def _counted(fn, *args, **kw):
    """Call a kernel wrapper; check it counted exactly one launch."""
    before = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D,N,kind,bias", [
    (8, 4096, 6144, "rmsnorm", False),      # llama3-8b decode
    (8, 1600, 4800, "layernorm", True),     # gpt2-xl decode
    (3, 256, 768, "layernorm", True),
    (8, 4096, 1024, "rmsnorm", False),      # the path's D over a split contraction
    (11, 128, 64, "rmsnorm", True),         # two batch passes, one tile
    (12, 1024, 512, "layernorm", True),     # two passes meet the split merge
    (2, 64, 25600, "rmsnorm", True),        # more column tiles than resident
                                            # blocks: the even grid
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
    # the split contraction's partials are merged in a fixed order: the
    # same inputs give the same bits
    assert torch.equal(got, tdec.fused_norm_qkv(x, scale, nb, w, bq,
                                                kind=kind, eps=1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,M,D,kind,parallel,bias", [
    (8, 4096, 4096, "rmsnorm", False, False),   # llama3-8b decode
    (8, 1600, 1600, "layernorm", False, True),  # gpt2-xl decode
    (3, 192, 256, "layernorm", False, True),
    (10, 128, 96, "layernorm", True, True),
    (12, 512, 256, "rmsnorm", False, True),     # two passes meet the split merge
    (9, 96, 8704, "layernorm", False, True),    # more column tiles than SMs:
                                                # the even grid, cooperative
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


def test_gemvs_launch_on_the_current_stream(cuda_device):
    """The lean host path of fused_norm_qkv and fused_proj_norm (bf16, the
    tensor cores): under torch.cuda.stream(s), behind a long sleep on s, the
    inputs are written on s and both kernels read them there, with their
    scratch and tickets kept for s."""
    dt = torch.bfloat16
    src = _randn((8, 1600), 0, dt, cuda_device, 2.0)
    scale = _randn((1600,), 1, dt, cuda_device) * 0.1 + 1
    w = _randn((1600, 4800), 2, dt, cuda_device, 1600 ** -0.5)
    wo = _randn((1600, 1600), 3, dt, cuda_device, 1600 ** -0.5)
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        x.copy_(src)
        y = _counted(tdec.fused_norm_qkv, x, scale, None, w, kind="rmsnorm",
                     eps=1e-5)
        r, h = _counted(tdec.fused_proj_norm, x, x, wo, None, scale,
                        kind="rmsnorm", eps=1e-5)
        done = s.record_event()
    done.synchronize()
    want = tdec._norm_qkv_ref(src, scale, torch.zeros_like(scale), w, None,
                              kind="rmsnorm", eps=1e-5)
    wr, wh = tdec._proj_norm_ref(src, src, wo, None, scale,
                                 torch.zeros_like(scale), kind="rmsnorm",
                                 eps=1e-5, parallel=False)
    for got, ref in ((y, want), (r, wr), (h, wh)):
        _close(got, ref, GEMV_TOL[dt])


def test_gemvs_lean_path_keeps_every_refusal(cuda_device):
    """The lean test falls back on the full checks, so each refusal raises
    its own error and launches nothing; bf16 and fp16 add a contraction of
    whole 16-byte vectors and 16-byte aligned activations."""
    dev, dt = cuda_device, torch.bfloat16
    x = torch.ones(2, 64, device=dev, dtype=dt)
    s = torch.ones(64, device=dev, dtype=dt)
    w = torch.ones(64, 64, device=dev, dtype=dt)
    before = (tdec.fused_norm_qkv.launches, tdec.fused_proj_norm.launches)
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_norm_qkv(torch.ones(2, 60, device=dev, dtype=dt),
                            torch.ones(60, device=dev, dtype=dt), None,
                            torch.ones(60, 64, device=dev, dtype=dt),
                            kind="rmsnorm")
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_proj_norm(torch.ones(2, 60, device=dev, dtype=dt), x,
                             torch.ones(60, 64, device=dev, dtype=dt), None, s,
                             kind="rmsnorm")
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_norm_qkv(torch.ones(2 * 64 + 1, device=dev, dtype=dt)[1:]
                            .view(2, 64), s, None, w, kind="rmsnorm")
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_norm_qkv(x, s, torch.ones(65, device=dev, dtype=dt)[1:],
                            w, kind="layernorm")
    with pytest.raises(TypeError, match="expected dtype"):
        tdec.fused_proj_norm(x, x.half(), w, None, s, kind="rmsnorm")
    with pytest.raises(ValueError, match="expected a tensor on"):
        tdec.fused_norm_qkv(x, s.cpu(), None, w, kind="rmsnorm")
    with pytest.raises(ValueError, match="norm kind"):
        tdec.fused_proj_norm(x, x, w, None, s, kind="batchnorm")
    assert (tdec.fused_norm_qkv.launches,
            tdec.fused_proj_norm.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,D,F,glu,bias,act", [
    (8, 4096, 14336, True, False, "silu"),      # llama3-8b decode
    (3, 256, 1024, False, True, "gelu"),
    (9, 128, 512, True, True, "gelu_exact"),
    (2, 64, 160, False, False, "relu"),
    (8, 1600, 6400, False, True, "gelu"),       # gpt2-xl decode
    (1, 4096, 14336, True, True, "silu"),       # one row
    (7, 200, 328, True, True, "silu"),          # F off the 64-column tile,
                                                # D off the 64-row stage
    (16, 1600, 6400, False, True, "gelu"),      # two passes of 8
    (12, 136, 200, False, True, "relu")])       # two passes, ragged
def test_fused_mlp_kernel_matches_plain(cuda_device, dtype, B, D, F, glu,
                                        bias, act):
    """fp32 on the FFMA kernels, bf16 and fp16 on the tensor cores (the
    down launch's contraction split and merged in order: the same bits on a
    second call)."""
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


@pytest.mark.parametrize("dtype", DTYPES)
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


# flash_decode's split: each row's keys over several blocks, merged in order

def _fd_chunk(dtype):
    """Keys a chunk holds at Dh 128 (the plan's arithmetic)."""
    return tdec.fd_chunk(128, torch.tensor([], dtype=dtype).element_size())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache", ["paged", "contig"])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_decode_split_depths_match_plain(cuda_device, dtype, cache,
                                               alibi):
    """llama3-8b's heads (32/8 of 128) at depths on the chunk edges (C - 1,
    C and C + 1 keys), depth 1, 2048 keys of a 2048-slot window, and rows
    whose depths end in different chunks, beside the plain version; two
    calls give the same bits."""
    B, H, Hkv, Dh, L = 8, 32, 8, 128, 2
    C = _fd_chunk(dtype)
    pos = torch.tensor([C - 2, C - 1, C, 0, 2047, 3 * C + 5, 2 * C - 1,
                        5 * C], device=cuda_device)
    q = _randn((B, H, Dh), 9, dtype, cuda_device)
    if cache == "paged":
        page = 16
        k, v, table = _paged(B, Hkv, page, 2048 // page, Dh, L, dtype,
                             cuda_device, 5)
        call = lambda p: tdec.flash_decode(q, k, v, p, layer=1, alibi=alibi,
                                           page_table=table)
        want = lambda p: tdec._flash_decode_paged_ref(
            q, k, v, p, table, scale=Dh ** -0.5, layer=1, alibi=alibi)
    else:
        k, v = _contig(B, Hkv, 2048, Dh, L, dtype, cuda_device, 5)
        call = lambda p: tdec.flash_decode(q, k, v, p, layer=1, alibi=alibi)
        want = lambda p: tdec._flash_decode_ref(q, k[1], v[1], p,
                                                scale=Dh ** -0.5, alibi=alibi)
    cases = [pos]
    if cache == "contig":       # one depth for the batch: the exact grid
        cases += [C - 2, C - 1, C, 0, 2047]
    for p in cases:
        got = call(p)
        torch.cuda.synchronize()
        _close(got, want(p), ATTN_TOL[dtype])
        assert torch.equal(got, call(p))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_many_splits_match_plain(cuda_device, dtype):
    """One row and one KV head (every chunk of 8192 keys its own block),
    GQA groups of 8 and of 1, and a pool of 1-token pages (a chunk's pages
    all different)."""
    q = _randn((1, 8, 64), 1, dtype, cuda_device)
    k, v = _contig(1, 1, 8193, 64, 1, dtype, cuda_device, 2)
    for p in (8192, 4000, 127):
        got = _counted(tdec.flash_decode_contig_cuda, q, k[0], v[0], p,
                       scale=0.125)
        _close(got, tdec._flash_decode_ref(q, k[0], v[0], p, scale=0.125),
               ATTN_TOL[dtype])
    q = _randn((2, 4, 64), 3, dtype, cuda_device)
    k, v, table = _paged(2, 4, 1, 600, 64, 1, dtype, cuda_device, 4)
    pos = torch.tensor([599, 130], device=cuda_device)
    got = _counted(tdec.flash_decode, q, k[0], v[0], pos, page_table=table)
    _close(got, tdec._flash_decode_paged_ref(q, k[0], v[0], pos, table,
                                             scale=0.125, layer=None,
                                             alibi=False), ATTN_TOL[dtype])


def test_flash_decode_no_key_gives_zeros(cuda_device):
    """A row with no key (pos -1: l == 0) comes out as zeros, as the Pallas
    kernel's l == 0 guard gives, beside rows that attend."""
    q = _randn((3, 8, 64), 1, torch.float32, cuda_device)
    k, v = _contig(3, 2, 300, 64, 1, torch.float32, cuda_device, 2)
    pos = torch.tensor([-1, 0, 299], device=cuda_device)
    got = _counted(tdec.flash_decode_contig_cuda, q, k[0], v[0], pos,
                   scale=0.125)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], tdec._flash_decode_ref(q, k[0], v[0], pos, scale=0.125)[1:],
           ATTN_TOL[torch.float32])


def test_flash_decode_launches_on_the_current_stream(cuda_device):
    """The lean host path of both caches: under torch.cuda.stream(s),
    behind a long sleep on s, q is written on s and both kernels read it
    there, with their scratch and tickets kept for s (deep rows: several
    splits a row, so the merge runs)."""
    dt = torch.bfloat16
    src = _randn((8, 32, 128), 0, dt, cuda_device)
    k, v = _contig(8, 8, 1024, 128, 1, dt, cuda_device, 1)
    kp, vp, table = _paged(8, 8, 64, 16, 128, 1, dt, cuda_device, 2)
    pos = torch.full((8,), 1000, device=cuda_device)
    q = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        q.copy_(src)
        y = _counted(tdec.flash_decode_contig_cuda, q, k[0], v[0], 1000,
                     scale=128 ** -0.5)
        yp = _counted(tdec.flash_decode, q, kp[0], vp[0], pos,
                      page_table=table)
        done = s.record_event()
    done.synchronize()
    _close(y, tdec._flash_decode_ref(src, k[0], v[0], 1000,
                                     scale=128 ** -0.5), ATTN_TOL[dt])
    _close(yp, tdec._flash_decode_paged_ref(src, kp[0], vp[0], pos, table,
                                            scale=128 ** -0.5, layer=None,
                                            alibi=False), ATTN_TOL[dt])


def test_flash_decode_lean_path_keeps_every_refusal(cuda_device):
    """The contiguous cache's refusals on the lean path (the paged pool's
    are test_decode_kernels_refuse_bad_inputs'), and the 16-byte alignment
    the bulk copies need on both: each raises its own error and launches
    nothing."""
    dev = cuda_device
    q = torch.ones(2, 4, 64, device=dev)
    kc = torch.ones(2, 2, 16, 64, device=dev)
    before = (tdec.flash_decode.launches, tdec.flash_decode_contig_cuda.launches)
    with pytest.raises(TypeError, match="int64"):
        tdec.flash_decode(q, kc, kc, torch.tensor([1, 2], device=dev).int())
    with pytest.raises(ValueError, match="1 or 2 depths"):
        tdec.flash_decode(q, kc, kc, torch.tensor([1, 2, 3], device=dev))
    with pytest.raises(ValueError, match="with B = 2"):
        tdec.flash_decode(q, kc[:1], kc[:1], 3)
    with pytest.raises(TypeError, match="expected dtype"):
        tdec.flash_decode(q, kc, kc.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.flash_decode(q, kc, kc.transpose(2, 3).contiguous()
                          .transpose(2, 3), 3)
    with pytest.raises(ValueError, match="head dim"):
        tdec.flash_decode(q[..., :60].contiguous(), kc[..., :60].contiguous(),
                          kc[..., :60].contiguous(), 3)
    with pytest.raises(ValueError, match="GQA"):
        tdec.flash_decode(torch.ones(2, 32, 64, device=dev), kc[:, :2][:, :1]
                          .contiguous(), kc[:, :1].contiguous(), 3)
    with pytest.raises(ValueError, match="layer"):
        tdec.flash_decode(q, kc[None], kc[None], 3, layer=1)
    with pytest.raises(ValueError, match="expected a tensor on"):
        tdec.flash_decode(q, kc.cpu(), kc, 3)
    odd = torch.ones(kc.numel() + 1, device=dev)[1:].view(kc.shape)
    with pytest.raises(ValueError, match="aligned"):
        tdec.flash_decode(q, odd, kc, 3)
    with pytest.raises(ValueError, match="aligned"):        # a paged pool
        tdec.flash_decode(q, kc, odd, torch.tensor([1, 2], device=dev),
                          page_table=torch.zeros(2, 1, dtype=torch.long,
                                                 device=dev))
    assert (tdec.flash_decode.launches,
            tdec.flash_decode_contig_cuda.launches) == before


def test_flash_decode_shared_memory_matches_the_plan(cuda_device):
    """The kernel's own shared-memory count equals fd_smem_bytes, the one
    the CPU tests bound, at every head dim, group and dtype."""
    import ctypes

    from deepspeed_tpu_torch.ops.kernels.build import bind

    smem = bind("decode", "ds_flash_decode_smem", [ctypes.c_int] * 4,
                ctypes.c_longlong)
    for itemsize in (2, 4):
        for Dh in range(8, 257, 8):
            chunk = tdec.fd_chunk(Dh, itemsize)
            for rep in range(1, 9):
                assert smem(Dh, rep, chunk, itemsize) == tdec.fd_smem_bytes(
                    Dh, rep, chunk, itemsize)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8192, 2048), (3, 5, 2048), (7, 100),
                                   (1, 64), (8192, 4096), (2048, 256),
                                   (8191, 2048), (777, 4096), (5, 8192),
                                   (0, 2048)])
def test_rms_norm_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    """llama-1b4's [micro * S, D] rows, a 3-D input, an odd row length (the
    element-by-element path) and a single row; mixtral-8x7b's [8192, 4096]
    train rows, mixtral-tiny's [2048, 256] (one-warp blocks), row counts
    that are no multiple of the warps a wave holds ([8191, 2048]) or that
    do not fill the row kernel's wave evenly ([777, 4096]), the row
    kernel's widest row, 16 warps a row, and no row at all (dγ zero)."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    dy = _randn(shape, 2, dtype, cuda_device)
    dx, dg = _counted(tln.rms_norm_bwd, x, g, dy, eps=1e-5)
    want_dx, want_dg = tln.rms_norm_bwd_plain(x, g, dy, eps=1e-5)
    assert dx.dtype == dtype and dg.dtype == dtype and dx.shape == x.shape
    _close(dx, want_dx, TOL[dtype])
    dg_tol = 1e-4 if dtype == torch.float32 else GRAD_REL_TOL[dtype]
    assert _rel_err(dg, want_dg) < dg_tol
    dx2, dg2 = tln.rms_norm_bwd(x, g, dy, eps=1e-5)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)   # no atomics


def test_rms_norm_bwd_launches_its_kernels(cuda_device):
    """bf16 and fp16 rows of up to 8192 elements in 16-byte vectors take the
    row kernel; fp32, odd widths and rows past 8192 the block kernel; each
    sums its partials with rms_dg_reduce_kernel, never LayerNorm's."""
    dev = cuda_device
    for dtype, n, row in ((torch.bfloat16, 2048, True), (torch.float16, 256, True),
                          (torch.bfloat16, 4096, True), (torch.float16, 8192, True),
                          (torch.bfloat16, 2056, True), (torch.float32, 2048, False),
                          (torch.bfloat16, 8200, False), (torch.bfloat16, 100, False)):
        x = _randn((64, n), 0, dtype, dev)
        g = torch.ones(n, device=dev, dtype=dtype)
        names, _ = _profiled_kernels(lambda: tln.rms_norm_bwd(x, g, x, eps=1e-5),
                                     ("rms_norm_bwd_", "rms_dg_reduce_kernel"))
        assert any("rms_norm_bwd_row_kernel" in e for e in names) == row, (dtype, n, names)
        assert any("rms_norm_bwd_kernel" in e for e in names) == (not row), names
        assert any("rms_dg_reduce_kernel" in e for e in names), names
        assert not any("layer_norm_dgb_sum" in e for e in names), names


def test_rms_norm_bwd_replays_in_a_cuda_graph(cuda_device):
    """llama-1b4's and mixtral-8x7b's train rows through the row kernel,
    captured in one CUDA graph: nothing is read back, so a replay on new
    inputs equals the eager calls bit for bit."""
    dev, dt = cuda_device, torch.bfloat16
    ins = [(_randn((8192, n), 0, dt, dev, 3.0), _randn((n,), 1, dt, dev) * 0.1 + 1,
            _randn((8192, n), 2, dt, dev)) for n in (2048, 4096)]

    def step():
        return [tln.rms_norm_bwd_cuda(x, g, dy, 1e-5) for x, g, dy in ins]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()                          # occupancy and bindings, eagerly
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    before = tln.rms_norm_bwd.launches
    with torch.cuda.graph(g, stream=s):
        outs = step()
    assert tln.rms_norm_bwd.launches == before + 2
    for i, (x, _, dy) in enumerate(ins):
        x.copy_(_randn(x.shape, 10 + i, dt, dev, 2.0))
        dy.copy_(_randn(dy.shape, 20 + i, dt, dev))
    g.replay()
    torch.cuda.synchronize()
    want = step()
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    x, gam, dy = ins[1]
    _close(outs[1][0], tln.rms_norm_bwd_plain(x, gam, dy, 1e-5)[0], 2e-2)


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


def _lse_plain(q, k, scale, causal=True, bias=None):
    S = q.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, tfa.NEG_INF)
    return torch.logsumexp(logits, -1)


def _flash_fwd_check(q, k, v, causal, alibi=False):
    """Forward (o and lse) against mha_reference (the tolerances above;
    under ``alibi`` the kernels' ALiBi instances against the reference with
    the JAX ALiBi bias), one launch counted: (o, lse)."""
    dtype, scale = q.dtype, q.shape[-1] ** -0.5
    fwd = tfa.wrappers(dtype, alibi)[0]
    counter = tfa.flash_attention if fwd is tfa.flash_fwd_cuda else fwd
    before = counter.launches
    o, lse = fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    bias = tfa._alibi_ref_bias(q, k, alibi)
    want_o = tfa.mha_reference(q, k, v, causal=causal, bias=bias)
    _close(o, want_o, ATTN_TOL[dtype])
    assert _rel_err(o, want_o) < O_REL_TOL[dtype]
    _close(lse, _lse_plain(q, k, scale, causal, bias), 1e-4)
    return o, lse


def _flash_roundtrip(q, k, v, do, causal, alibi=False):
    """Forward as _flash_fwd_check, backward (dq, dk, dv) against autograd
    of mha_reference on the same inputs in fp32 (the tolerances above), one
    launch counted, and two backward calls give the same bits."""
    dtype, scale = q.dtype, q.shape[-1] ** -0.5
    o, lse = _flash_fwd_check(q, k, v, causal, alibi)
    bwd = tfa.wrappers(dtype, alibi)[1]
    grads = _counted(bwd, q, k, v, o, lse, do, causal, scale)
    # detached: fp32's .float() is q itself, whose grad would accumulate
    # over two roundtrips on the same inputs
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    tfa.mha_reference(*ref, causal=causal,
                      bias=tfa._alibi_ref_bias(q, k, alibi)).backward(do.float())
    for got, r, name in zip(grads, ref, "qkv"):
        assert got.dtype == dtype and got.shape == q.shape
        assert _rel_err(got, r.grad) < GRAD_REL_TOL[dtype], name
    again = bwd(q, k, v, o, lse, do, causal, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,S,D", [(4, 16, 2048, 128),   # llama-1b4
                                     (2, 3, 200, 128),     # ragged S
                                     (1, 2, 64, 64), (1, 1, 1, 128),
                                     (4, 8, 512, 32),      # llama-tiny's heads
                                     (2, 3, 200, 32)])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, B, H, S, D):
    """The path's shapes, causal, fp32, bf16 and fp16."""
    _flash_roundtrip(*_attn_inputs(B, H, S, D, dtype, cuda_device), causal=True)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("S", [128, 200, 2048])
@pytest.mark.parametrize("H", [16, 12])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_alibi_kernels_match_plain(cuda_device, dtype, D, H, S,
                                                   alibi):
    """The ALiBi instances against mha_reference with the JAX ALiBi bias,
    and the instances without it on the same inputs: every head dim, 16
    heads and 12 (whose slopes interpolate), S on a block edge, ragged and
    at BLOOM's training length."""
    q, k, v, do = _attn_inputs(1, H, S, D, dtype, cuda_device, seed=D + S)
    _flash_roundtrip(q, k, v, do, causal=True, alibi=alibi)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,S,D", [(2, 3, 200, 64), (1, 12, 257, 128),
                                     (4, 16, 2048, 128)])   # bloom-1b7
def test_flash_attention_alibi_batches_and_non_causal(cuda_device, dtype, B, H,
                                                      S, D):
    """ALiBi over B > 1 (grid row b * H + h reads slope h) and without the
    causal mask (the bias on every key tile, the mask only on the ragged
    one)."""
    q, k, v, do = _attn_inputs(B, H, S, D, dtype, cuda_device, seed=9)
    _flash_roundtrip(q, k, v, do, causal=True, alibi=True)
    if S < 2048:
        _flash_roundtrip(q, k, v, do, causal=False, alibi=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 192, 257, 1000])
def test_flash_attention_bwd_tile_edges(cuda_device, S, D, dtype):
    """The 16-bit backward's 128-row blocks and 64-row streamed tiles: S on,
    just under and just over each edge, at every head dim."""
    q, k, v, do = _attn_inputs(1, 2, S, D, dtype, cuda_device, seed=S)
    _flash_roundtrip(q, k, v, do, causal=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,S,D", [(2, 3, 200, 64), (1, 2, 257, 128)])
def test_flash_attention_kernels_non_causal(cuda_device, dtype, B, H, S, D):
    """causal=False: every key tile, the mask only on the ragged one."""
    q, k, v, do = _attn_inputs(B, H, S, D, dtype, cuda_device, seed=7)
    _flash_roundtrip(q, k, v, do, causal=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,S,D", [(1, 1, 1000, 128),    # B*H = 1
                                     (2, 40, 512, 64)])    # 320 blocks
def test_flash_attention_bwd_grid_extremes(cuda_device, B, H, S, D, dtype):
    """One head (a grid of 8 blocks on 132 SMs) and more blocks than SMs."""
    q, k, v, do = _attn_inputs(B, H, S, D, dtype, cuda_device, seed=3)
    _flash_roundtrip(q, k, v, do, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,S,D", [(4, 16, 2048, 128), (2, 3, 257, 64),
                                     (1, 2, 200, 32)])
def test_flash_attention_fwd_repeats_bit_equal(cuda_device, B, H, S, D, dtype):
    """The 16-bit forward: two calls give the same bits, o and lse."""
    q, k, v, _ = _attn_inputs(B, H, S, D, dtype, cuda_device, seed=5)
    fwd = tfa.wrappers(dtype, False)[0]
    o, lse = fwd(q, k, v, True, D ** -0.5)
    o2, lse2 = fwd(q, k, v, True, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,S,D", [(1, 2, 1000, 128), (1, 2, 257, 64)])
def test_flash_attention_fwd_large_logits(cuda_device, B, H, S, D, dtype):
    """q x 16: logits of tens, so the running max jumps across tiles and
    alpha falls far below 1; the forward still matches mha_reference under
    the same tolerances."""
    q, k, v, _ = _attn_inputs(B, H, S, D, dtype, cuda_device, seed=11)
    _flash_fwd_check((q.float() * 16).to(dtype), k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [192, 320])
def test_flash_attention_fwd_last_block_half_empty(cuda_device, S, D, dtype):
    """S an odd multiple of 64: the last 128-row block's second warpgroup
    holds no row below S, and warpgroup 0 of each earlier block computes
    one fully masked tile."""
    q, k, v, do = _attn_inputs(1, 2, S, D, dtype, cuda_device, seed=S)
    _flash_roundtrip(q, k, v, do, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_fwd_shared_memory(cuda_device, D, dtype):
    """The 16-bit forward's dynamic shared memory (the resident 128-row Q
    tile, four stages of a 64-row K and V pair, eight mbarriers, the 1 KB
    alignment pad) is what the launch takes and fits the card's opt-in
    limit of 232,448 B."""
    smem = tfa._library().lib.ds_flash_fwd_smem_bytes(D)
    assert smem == 1024 + 128 * D * 2 + 2 * 4 * 64 * D * 2 + 2 * 4 * 8
    limit = getattr(torch.cuda.get_device_properties(cuda_device),
                    "shared_memory_per_block_optin", 232448)
    assert smem <= min(limit, 232448)
    _flash_fwd_check(*_attn_inputs(1, 1, 129, D, dtype, cuda_device)[:3],
                     causal=True)


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
        tfa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    # alibi=True takes the ALiBi instances, forward and backward, and not
    # the others
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (tfa.flash_attention, tfa.flash_attention_bwd,
              tfa.flash_fwd_alibi_cuda, tfa.flash_attention_bwd_alibi)
    before = [c.launches for c in counts]
    tfa.flash_attention(*leaves, alibi=True).backward(do)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [0, 0, 1, 1]
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    tfa.mha_reference(*ref, bias=tfa._alibi_ref_bias(q, k, True)).backward(
        do.float())
    for got, r in zip(leaves, ref):
        assert _rel_err(got.grad, r.grad) < 2e-2
    # fp16 takes the fp16 instances, with and without ALiBi, and no other
    counts += (tfa.flash_fwd_f16_cuda, tfa.flash_attention_bwd_f16,
               tfa.flash_fwd_f16_alibi_cuda, tfa.flash_attention_bwd_f16_alibi)
    for alibi, want in ((False, [0, 0, 0, 0, 1, 1, 0, 0]),
                        (True, [0, 0, 0, 0, 0, 0, 1, 1])):
        leaves = [t.half().requires_grad_() for t in (q, k, v)]
        before = [c.launches for c in counts]
        tfa.flash_attention(*leaves, alibi=alibi).backward(do.half())
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counts, before)] == want
        assert all(t.grad.dtype == torch.float16 for t in leaves)
    # each wrapper takes only its own dtypes
    with pytest.raises(TypeError, match="f16"):
        tfa.flash_fwd_cuda(q.half(), k.half(), v.half(), True, 0.125)
    with pytest.raises(TypeError, match="f16"):
        tfa.flash_fwd_f16_cuda(q, k, v, True, 0.125)


@pytest.mark.parametrize("alibi", [False, True])
def test_flash_attention_f16_overflow_stays_visible(cuda_device, alibi):
    """What the loss scaler needs of the fp16 kernels: an inf in do gives
    non-finite dq, dk and dv, and a finite do whose gradients pass fp16's
    range gives inf where the plain version's fp32 value is past 65520
    (where fp16's round to nearest goes to inf), never a clamped finite
    value; where that value is well inside the range the kernel's is
    finite.  do = 30000 in every element makes dv_j = 30000 times column
    j's sum of p, which reaches ~8 at S 2048 (the harmonic sum of the
    early keys; under ALiBi in the last head, whose slope 2^-8 keeps ~256
    keys in view, ~5)."""
    q, k, v, _ = _attn_inputs(1, 4, 2048, 128, torch.float16, cuda_device,
                              seed=13)
    fwd, bwd = tfa.wrappers(torch.float16, alibi)
    o, lse = fwd(q, k, v, True, 128 ** -0.5)
    do = torch.full_like(q, 30000.0)
    do[0, 0, 77, 5] = float("inf")          # head 0 sees an inf
    dq, dk, dv = bwd(q, k, v, o, lse, do, True, 128 ** -0.5)
    torch.cuda.synchronize()
    for g in (dq, dk, dv):
        assert not torch.isfinite(g[0, 0]).all()
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    tfa.mha_reference(*ref, bias=tfa._alibi_ref_bias(q, k, alibi)).backward(
        do.float())
    want = ref[2].grad[0, 3].abs()          # head 3: do finite
    got = dv[0, 3].float()
    assert (want > 65520 * 1.01).any()
    assert torch.isinf(got[want > 65520 * 1.01]).all()
    assert torch.isfinite(got[want < 65504 * 0.99]).all()


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
    (torch.float16, torch.float32), (torch.float32, torch.float16)])
@pytest.mark.parametrize("n,adam_w_mode", [(2048 * 5632, True),
                                           (1000003, False), (3, True),
                                           (1600, True)])   # a gpt2-xl norm leaf
def test_fused_adam_kernel_matches_plain(cuda_device, p_dtype, g_dtype, n,
                                         adam_w_mode):
    """Three steps in place from the same inputs: a llama-1b4 MLP leaf, an
    odd length (the scalar tail), and fewer elements than one vector; an
    fp16 param through its own instance's wrapper, at lr 1e-2 x step so
    each step moves p by many fp16 ulps, each step from the kernel's own
    state: p within one ulp of the plain version's (the same fp32 update,
    each side rounded to fp16; an ulp carried over steps from a larger |p|
    would be many ulps of a p that lands near zero), more than 98 % of it
    moved, m and v (fp32, near 0.1) at 1e-6."""
    f16 = p_dtype == torch.float16
    p = _randn((n,), 0, p_dtype, cuda_device)
    m = torch.zeros(n, device=cuda_device)
    v = torch.zeros(n, device=cuda_device)
    p0, state = p.clone(), [p.clone(), m.clone(), v.clone()]
    for step in (1, 2, 3):
        g = _randn((n,), step, g_dtype, cuda_device)
        kw = dict(lr=(1e-2 if f16 else 1e-3) * step, beta1=0.9, beta2=0.95,
                  eps=1e-8, weight_decay=0.1, adam_w_mode=adam_w_mode)
        counter = (tadam.fused_adam_update_f16_cuda if f16
                   else tadam.fused_adam_update)
        if f16:
            state = [p.clone(), m.clone(), v.clone()]
        before = counter.launches
        tadam.fused_adam_update(p, g, m, v, step, **kw)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        tadam.fused_adam_update_plain(*state[:1], g, *state[1:], step, **kw)
        if f16:
            _within_f16_ulp(p, state[0])
    tol = 1e-6 if p_dtype != torch.bfloat16 else TOL[p_dtype]
    if f16:
        assert n < 1600 or (p != p0).float().mean() > 0.98
    else:
        _close(p, state[0], tol)
    for got, want in zip((m, v), state[1:]):
        _close(got, want, tol)


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


def _fp16_skip_rows(dev, max_rows=32):
    """A small llama (4 heads of 32) trained under fp16 from a dynamic
    scale of 2^24, hysteresis 1, window 3, on one repeated batch of 2 x 32
    tokens a micro-batch: the first steps overflow (the logits' gradient
    alone is ~2^24 / (64 x 2) = 131072 past fp16's 65504) and halve the
    scale until it fits.  Per step: (scale before, skipped, scale after,
    the state bit-equal to before, fused_adam, fp16 flash forward and
    other flash forward launches during the step, loss)."""
    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "fp16": {"enabled": True, "initial_scale_power": 24,
                    "hysteresis": 1, "loss_scale_window": 3},
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    model = deepspeed_tpu_torch.causal_lm(
        "llama-tiny", device="cpu", num_layers=2, hidden_size=128,
        intermediate_size=256, num_heads=4, num_kv_heads=4, vocab_size=256)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device=dev)
    tok = np.random.default_rng(10).integers(0, 256, (4, 32))
    counts = (tadam.fused_adam_update, tfa.flash_fwd_f16_cuda, tfa.flash_attention)
    rows = []
    while len(rows) < 12 or rows[-1][1]:      # end on an applied step
        assert len(rows) < max_rows
        before = ([p.clone() for p in engine.master],
                  [t.clone() for st in engine.optimizer.state.values()
                   for t in st.values()],
                  engine.optimizer.count, engine.global_steps)
        scale, launched = engine.loss_scale, [c.launches for c in counts]
        loss = float(engine.train_step((tok, tok)))
        after = ([p for p in engine.master],
                 [t for st in engine.optimizer.state.values() for t in st.values()],
                 engine.optimizer.count, engine.global_steps)
        same = (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
                and len(before[1]) == len(after[1])
                and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
                and before[2:] == after[2:])
        rows.append((scale, engine._last_overflow, engine.loss_scale, same,
                     *[c.launches - n for c, n in zip(counts, launched)], loss))
    return engine, rows


def test_fp16_overflow_skip_on_card(cuda_device):
    """The skip-on-overflow step on the card: has_overflow over CUDA
    accumulators, its one host read, and a skipped step that leaves the
    fp32 masters, Adam's moments, the optimizer's count and global_steps
    bit-equal and launches no fused_adam.  The scale halves on each skip
    (hysteresis 1), doubles after every 3 clean steps and follows the
    port's scaler for the flags seen (the scaler is held to JAX on the
    CPU); every step runs the fp16 flash instances and no other."""
    from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as scaler_lib

    engine, rows = _fp16_skip_rows(cuda_device)
    skips = [r[1] for r in rows]
    assert skips[0] and not all(skips)
    fp16 = engine.config.fp16
    state = scaler_lib.make_state(fp16)
    for scale, skipped, new_scale, same, adam, f16_fwd, fwd, loss in rows:
        # one forward a layer and a micro-batch: 2 x 2
        assert np.isfinite(loss) and f16_fwd == 2 * 2 and fwd == 0
        state = scaler_lib.update(
            state, skipped, dynamic=fp16.dynamic_loss_scale,
            loss_scale_window=fp16.loss_scale_window,
            min_loss_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        assert new_scale == float(state.scale)
        if skipped:
            assert same and adam == 0 and new_scale == scale / 2
        else:
            assert not same and adam > 0
    assert engine.skipped_steps == sum(skips)
    assert engine.global_steps == len(rows) - sum(skips)
    # the overflow test over CUDA accumulators, and the unscale's quotient
    from deepspeed_tpu_torch.runtime.utils import has_overflow

    acc = [torch.ones(1000, device=cuda_device) for _ in range(3)]
    assert not bool(has_overflow(acc))
    for bad in (float("inf"), float("-inf"), float("nan")):
        acc[1][517] = bad
        assert bool(has_overflow(acc))
    x = _randn((1 << 20,), 3, torch.float32, cuda_device, 1e4)
    got = [x.clone()]
    torch._foreach_div_(got, torch.full((), 1000.0, device=cuda_device))
    assert torch.equal(got[0], (x.double() / 1000).float())


# ---------------------------------------------------------------------------
# LayerNorm, softmax, bias_act (the gpt2 family)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8192, 1600), (8, 1600), (64, 768),
                                   (7, 40), (13, 2048), (5, 100),
                                   (3, 5, 4096)]
                         + [s for s in _NORM_SHAPES if s not in ((8192, 1600), (8, 1600))]
                         + [(4099, 2056), (1, 8)])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, shape):
    """gpt2-xl's training rows and decode rows, gpt2-small's width, a row
    shorter than a warp's vectors and a ragged row count, every row count
    of _NORM_ROWS at every width of _NORM_WIDTHS (rows of up to 2048
    elements in registers: a block of warps a row, or the streaming warps
    past one block an SM), then the block-per-row path: a row length that
    is no multiple of the vector (also at many rows), and rows longer than
    2048; a second call gives the same bits."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0) + 1.5
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    b = _randn(shape[-1:], 2, dtype, cuda_device) * 0.1
    got = _counted(tln.layer_norm, x, g, b, eps=1e-5)
    want = tln.layer_norm_plain(x, g, b, eps=1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, TOL[dtype])
    assert torch.equal(got, tln.layer_norm(x, g, b, eps=1e-5))


def test_layer_norm_lean_path_keeps_every_refusal(cuda_device):
    """The one-pass attribute test of the LayerNorm call's lean host path
    falls back on the shared checks, so each refusal raises what it raised
    before, and no kernel is launched: a non-contiguous x, gamma or beta, a
    gamma or beta of another dtype or shape, a gamma or beta on the CPU
    beside a CUDA x, an x of no kernel dtype, an x on the CPU."""
    bf = torch.bfloat16
    x = torch.ones(4, 64, device=cuda_device, dtype=bf)
    g = torch.ones(64, device=cuda_device, dtype=bf)
    strided = torch.ones(64, 2, device=cuda_device, dtype=bf)[:, 0]
    before = tln.layer_norm.launches
    with pytest.raises(ValueError, match="contiguous"):
        tln.layer_norm(torch.ones(64, 4, device=cuda_device, dtype=bf).t(), g, g)
    with pytest.raises(ValueError, match="contiguous"):
        tln.layer_norm(x, strided, g)
    with pytest.raises(ValueError, match="contiguous"):
        tln.layer_norm(x, g, strided)
    with pytest.raises(TypeError, match="expected dtype"):
        tln.layer_norm(x, g.float(), g)
    with pytest.raises(TypeError, match="expected dtype"):
        tln.layer_norm(x, g, g.float())
    for bad in (torch.ones(65, device=cuda_device, dtype=bf),
                torch.ones(1, 64, device=cuda_device, dtype=bf)):
        with pytest.raises(ValueError, match="must be"):
            tln.layer_norm(x, bad, g)
        with pytest.raises(ValueError, match="must be"):
            tln.layer_norm(x, g, bad)
    with pytest.raises(ValueError, match="expected a tensor on"):
        tln.layer_norm(x, g.cpu(), g)
    with pytest.raises(ValueError, match="expected a tensor on"):
        tln.layer_norm(x, g, g.cpu())
    with pytest.raises(TypeError, match="not supported"):
        tln.layer_norm(x.to(torch.int32), g.to(torch.int32), g.to(torch.int32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tln.layer_norm_cuda(x.cpu(), g, g)
    assert tln.layer_norm.launches == before


def test_layer_norm_launches_on_the_current_stream(cuda_device):
    """Under torch.cuda.stream(s) the kernel goes to s: behind a long sleep
    on s, x is written on s and normalised on s, so the output recorded on
    s holds x's norm (on another stream the kernel would have read the
    zeros that x held before); at decode rows and at training rows."""
    for shape in ((8, 1600), (8192, 1600)):
        src = _randn(shape, 0, torch.bfloat16, cuda_device, 3.0) + 1.5
        g = _randn(shape[-1:], 1, torch.bfloat16, cuda_device) * 0.1 + 1
        b = _randn(shape[-1:], 2, torch.bfloat16, cuda_device) * 0.1
        x = torch.zeros_like(src)
        torch.cuda.synchronize()
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)
            x.copy_(src)
            y = _counted(tln.layer_norm, x, g, b, eps=1e-5)
            done = s.record_event()
        done.synchronize()
        _close(y, tln.layer_norm_plain(src, g, b, 1e-5), TOL[torch.bfloat16])


@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_forwards_launch_their_kernels(cuda_device, kind):
    """Rows in 16-byte vectors that fit in registers take the row kernel, or
    for LayerNorm over more rows of up to a warp's width than 8 an SM the
    streaming kernel; the other rows the block-per-row kernels, never the
    register ones."""
    dev = cuda_device
    layer = kind == "layer_norm"
    fn = getattr(tln, kind)
    row = f"{kind}_fwd_row_kernel"
    stream = "layer_norm_fwd_stream_kernel" if layer else row
    block = "layer_norm_fwd_block_kernel" if layer else "rms_norm_fwd_kernel"
    cases = [((8, 1600), torch.bfloat16, row), ((64, 2048), torch.bfloat16, row),
             ((8192, 1600), torch.bfloat16, stream), ((8192, 2048), torch.float16, stream),
             ((8192, 1600), torch.float32, row), ((7, 100), torch.bfloat16, block),
             ((8, 4096), torch.bfloat16, block if layer else row),
             ((1600, 4096), torch.bfloat16, block if layer else row),
             ((3, 20000), torch.bfloat16, block)]
    for shape, dtype, want in cases:
        x = _randn(shape, 0, dtype, dev)
        g = torch.ones(shape[-1], device=dev, dtype=dtype)
        args = (g, g) if layer else (g,)
        names, _ = _profiled_kernels(lambda: fn(x, *args, eps=1e-5), (f"{kind}_fwd_",))
        names = [k for k in names if f"{kind}_fwd_" in k]
        assert len(names) == 1 and want in names[0], (shape, dtype, names)


@pytest.mark.parametrize("kind", ["layer_norm_bwd", "rms_norm_bwd"])
def test_norm_backward_lean_paths_keep_every_refusal(cuda_device, kind):
    """The backwards' one-pass attribute test falls back on the shared
    checks: each refusal raises what it raised before, with no launch."""
    bf = torch.bfloat16
    fn = getattr(tln, kind)
    cuda = getattr(tln, kind + "_cuda")
    x = torch.ones(4, 64, device=cuda_device, dtype=bf)
    g = torch.ones(64, device=cuda_device, dtype=bf)
    before = fn.launches
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones(64, 4, device=cuda_device, dtype=bf).t(), g, x)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x, g, torch.ones(64, 4, device=cuda_device, dtype=bf).t())
    with pytest.raises(TypeError, match="expected dtype"):
        fn(x, g.float(), x)
    with pytest.raises(TypeError, match="expected dtype"):
        fn(x, g, x.float())
    with pytest.raises(ValueError, match="gamma"):
        fn(x, torch.ones(65, device=cuda_device, dtype=bf), x)
    with pytest.raises(ValueError, match="dy"):
        fn(x, g, torch.ones(5, 64, device=cuda_device, dtype=bf))
    with pytest.raises(ValueError, match="expected a tensor on"):
        fn(x, g.cpu(), x)
    with pytest.raises(ValueError, match="expected a tensor on"):
        fn(x, g, x.cpu())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cuda(x.cpu(), g, x)
    wide = 6152 if kind == "layer_norm_bwd" else 12296
    xw = torch.ones(2, wide, device=cuda_device, dtype=bf)
    with pytest.raises(ValueError, match=str(wide - 8)):
        fn(xw, torch.ones(wide, device=cuda_device, dtype=bf), xw)
    assert fn.launches == before


@pytest.mark.parametrize("kind", ["layer_norm_bwd", "rms_norm_bwd"])
def test_norm_backwards_launch_on_the_current_stream(cuda_device, kind):
    """The backwards' launches go to the current stream: behind a long
    sleep on s, dy is written on s and the backward reads it there."""
    x = _randn((8192, 2048), 0, torch.bfloat16, cuda_device, 3.0) + 1.5
    g = _randn((2048,), 1, torch.bfloat16, cuda_device) * 0.1 + 1
    src = _randn((8192, 2048), 2, torch.bfloat16, cuda_device)
    dy = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        dy.copy_(src)
        got = _counted(getattr(tln, kind), x, g, dy, eps=1e-5)
        done = s.record_event()
    done.synchronize()
    want = getattr(tln, kind + "_plain")(x, g, src, 1e-5)
    _close(got[0], want[0], TOL[torch.bfloat16])
    assert _rel_err(got[1], want[1]) < GRAD_REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8192, 1600), (8192, 2048), (4099, 1600),
                                   (5, 2048), (5, 2056), (3, 5, 768), (7, 100),
                                   (1, 64), (600, 6144), (0, 1600)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    """gpt2-xl's and bloom-1b7's [micro * S, D] rows, a row count that does
    not divide into the warps of a block, the longest row of the 16-bit warp
    kernel and one just past it, a 3-D input, an odd row length (the
    element-by-element path), a single row, the longest row the
    block-per-row kernel takes (48 KB of partials: more than a block's
    default shared memory), and no row at all (dγ and dβ zero)."""
    x = _randn(shape, 0, dtype, cuda_device, 3.0) + 1.5
    g = _randn(shape[-1:], 1, dtype, cuda_device) * 0.1 + 1
    dy = _randn(shape, 2, dtype, cuda_device)
    dx, dg, db = _counted(tln.layer_norm_bwd, x, g, dy, eps=1e-5)
    want_dx, want_dg, want_db = tln.layer_norm_bwd_plain(x, g, dy, eps=1e-5)
    assert dx.dtype == dg.dtype == db.dtype == dtype and dx.shape == x.shape
    assert dg.shape == db.shape == g.shape
    _close(dx, want_dx, TOL[dtype])
    tol = 1e-4 if dtype == torch.float32 else GRAD_REL_TOL[dtype]
    assert _rel_err(dg, want_dg) < tol and _rel_err(db, want_db) < tol
    again = tln.layer_norm_bwd(x, g, dy, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))


def test_layer_norm_bwd_takes_row_widths_in_any_order(cuda_device):
    """The warp-per-row kernel's shared memory grows with the row: a narrow
    row after a wide one, and a wide one again, each launch and match the
    plain version (the kernel's opt-in to more shared memory is never
    lowered by a narrower row)."""
    dev = cuda_device
    for n in (2048, 768, 1600, 64, 2048):
        x = _randn((257, n), 0, torch.bfloat16, dev, 3.0) + 1.5
        g = _randn((n,), 1, torch.bfloat16, dev) * 0.1 + 1
        dy = _randn((257, n), 2, torch.bfloat16, dev)
        dx, dg, db = tln.layer_norm_bwd(x, g, dy, eps=1e-5)
        want_dx, want_dg, want_db = tln.layer_norm_bwd_plain(x, g, dy, eps=1e-5)
        _close(dx, want_dx, TOL[torch.bfloat16])
        assert _rel_err(dg, want_dg) < GRAD_REL_TOL[torch.bfloat16]
        assert _rel_err(db, want_db) < GRAD_REL_TOL[torch.bfloat16]


def test_layer_norm_bwd_launches_the_warp_kernel_for_16_bit_rows(cuda_device):
    """bf16 and fp16 rows of up to 2048 elements in 16-byte vectors run the
    warp-per-row kernel; fp32, longer rows and odd row lengths the
    block-per-row one; each sums its partials with LayerNorm's own kernel,
    never RMSNorm's."""
    dev = cuda_device
    for dtype, n, warp in ((torch.bfloat16, 1600, True), (torch.float16, 2048, True),
                           (torch.bfloat16, 2056, False), (torch.float32, 1600, False),
                           (torch.bfloat16, 104, True), (torch.bfloat16, 1604, False)):
        x = _randn((64, n), 0, dtype, dev)
        g = torch.ones(n, device=dev, dtype=dtype)
        names, _ = _profiled_kernels(lambda: tln.layer_norm_bwd(x, g, x, eps=1e-5),
                                     ("layer_norm_bwd_", "layer_norm_dgb_sum_kernel"))
        assert any("layer_norm_bwd_warp_kernel" in k for k in names) == warp, names
        assert any("layer_norm_bwd_kernel" in k for k in names) != warp, names
        assert any("layer_norm_dgb_sum_kernel" in k for k in names), names
        assert not any("rms_dg_reduce" in k for k in names), names


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
            # the norms' forwards test x.is_cuda before use_kernel (their
            # lean host path): their dispatch goes to the plain versions too
            monkeypatch.setattr(tln, "_layer_norm_fwd", tln.layer_norm_plain)
            monkeypatch.setattr(tln, "_rms_norm_fwd", tln.rms_norm_plain)
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


# ---------------------------------------------------------------------------
# generate(): the contiguous flash_decode, the int8 GEMVs, flash at Dh 32
# ---------------------------------------------------------------------------

def test_every_preset_head_dim_has_a_flash_kernel():
    """The training path's flash kernels take every preset's head dim (no
    card needed: the set the wrapper checks against)."""
    from deepspeed_tpu_torch.models.config import _PRESETS, get_model_config

    dims = {name: get_model_config(name).head_dim for name in _PRESETS}
    assert all(d in tfa._HEAD_DIMS for d in dims.values()), dims


def _contig(B, Hkv, Smax, Dh, L, dtype, dev, seed):
    k = _randn((L, B, Hkv, Smax, Dh), seed, dtype, dev)
    v = _randn((L, B, Hkv, Smax, Dh), seed + 1, dtype, dev)
    return k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Smax", [512, 1025, 64, 8193])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_decode_contig_kernel_matches_plain(cuda_device, dtype, Smax,
                                                  per_row, alibi):
    """generate()'s cache at llama3-8b's decode shape (8 rows, 32/8 heads of
    128) stacked [2, 8, 8, Smax, 128] and read at layer 1: Smax a power of
    two, generate()'s default 1025 and 8193 (no 256-multiple), depths 1 to
    Smax (a scalar for the batch, or one a row)."""
    B, H, Hkv, Dh, L = 8, 32, 8, 128, 2
    k, v = _contig(B, Hkv, Smax, Dh, L, dtype, cuda_device, 0)
    q = _randn((B, H, Dh), 9, dtype, cuda_device)
    if per_row:
        pos = torch.tensor(np.linspace(0, Smax - 1, B).astype(np.int64),
                           device=cuda_device)
        cases = [pos]
    else:
        cases = [0, Smax // 2, Smax - 1]
    for pos in cases:
        before = tdec.flash_decode.launches
        got = _counted(tdec.flash_decode_contig_cuda, q, k, v, pos,
                       scale=Dh ** -0.5, layer=1, alibi=alibi)
        assert tdec.flash_decode.launches == before       # not the paged one
        want = tdec._flash_decode_ref(q, k[1], v[1], pos, scale=Dh ** -0.5,
                                      alibi=alibi)
        _close(got, want, ATTN_TOL[dtype])
        assert torch.equal(got, tdec.flash_decode(q, k, v, pos, layer=1,
                                                  alibi=alibi))


@pytest.mark.parametrize("Dh,H,Hkv,Smax", [(64, 25, 25, 512),    # gpt2-xl
                                           (32, 8, 2, 100), (256, 16, 2, 33),
                                           (40, 6, 3, 7)])
def test_flash_decode_contig_kernel_odd_shapes(cuda_device, Dh, H, Hkv, Smax):
    """One query head a KV head (gpt2-xl), GQA groups up to 8, head dims
    below and above a warp's width, an unstacked cache (layer=None), and a
    one-element position tensor broadcast to every row."""
    B = 3
    k, v = _contig(B, Hkv, Smax, Dh, 1, torch.float32, cuda_device, 3)
    q = _randn((B, H, Dh), 4, torch.float32, cuda_device)
    for pos in (torch.tensor([Smax - 2], device=cuda_device),
                torch.tensor([0, Smax // 3, Smax - 1], device=cuda_device)):
        got = _counted(tdec.flash_decode_contig_cuda, q, k[0], v[0], pos,
                       scale=Dh ** -0.5)
        want = tdec._flash_decode_ref(q, k[0], v[0], pos, scale=Dh ** -0.5)
        _close(got, want, ATTN_TOL[torch.float32])


def _int8_weight(shape, seed, dev):
    from deepspeed_tpu_torch.models.quant import quantize_weight

    w = _randn(shape, seed, torch.bfloat16, dev, shape[0] ** -0.5)
    qt = quantize_weight(w)
    return qt.q, qt.scale.reshape(-1)


@pytest.mark.parametrize("B,D,N,kind,bias", [
    (8, 4096, 6144, "rmsnorm", False),      # llama3-8b decode
    (8, 1600, 4800, "layernorm", True),     # gpt2-xl decode
    (3, 256, 200, "rmsnorm", True),         # a ragged last tile
    (1, 4096, 6144, "rmsnorm", True),       # one row
    (12, 1600, 4800, "layernorm", False),   # two passes of 8
    (5, 136, 264, "layernorm", True),       # D off the 128-row stage, rows
                                            # of 8 bytes: cp.async
    (16, 512, 1000, "rmsnorm", True),       # two passes, cp.async
    (2, 64, 25600, "rmsnorm", False)])      # more column tiles than resident
                                            # blocks: the even grid
def test_fused_norm_qkv_int8_kernel_matches_plain(cuda_device, B, D, N, kind,
                                                  bias):
    dt = torch.bfloat16
    x = _randn((B, D), 0, dt, cuda_device, 2.0)
    scale = _randn((D,), 1, dt, cuda_device) * 0.1 + 1
    nb = _randn((D,), 2, dt, cuda_device)
    w, ws = _int8_weight((D, N), 3, cuda_device)
    bq = _randn((N,), 4, dt, cuda_device) if bias else None
    dense = tdec.fused_norm_qkv.launches
    got = _counted(tdec.fused_norm_qkv_int8_cuda, x, scale, nb, w, ws, bq,
                   kind=kind, eps=1e-5)
    assert tdec.fused_norm_qkv.launches == dense
    want = tdec._norm_qkv_ref(x, scale, nb, w, bq, kind=kind, eps=1e-5,
                              wscale=ws)
    assert got.dtype == dt and got.shape == (B, N)
    _close(got, want, GEMV_TOL[dt])
    assert torch.equal(got, tdec.fused_norm_qkv(x, scale, nb, w, bq, kind=kind,
                                                eps=1e-5, wscale=ws))


@pytest.mark.parametrize("B,M,D,kind,parallel,bias", [
    (8, 4096, 4096, "rmsnorm", False, False),   # llama3-8b decode
    (8, 1600, 1600, "layernorm", False, True),  # gpt2-xl decode
    (3, 192, 200, "layernorm", True, True),     # a ragged last tile, rows of
                                                # 8 bytes: cp.async
    (1, 4096, 4096, "rmsnorm", False, True),    # one row
    (12, 1600, 1600, "layernorm", True, False), # two passes of 8
    (5, 136, 264, "layernorm", False, True),    # M off the 128-row stage
    (16, 512, 1000, "rmsnorm", False, True),    # two passes, cp.async
    (2, 64, 25600, "rmsnorm", False, False)])   # more column tiles than
                                                # resident blocks: the even grid
def test_fused_proj_norm_int8_kernel_matches_plain(cuda_device, B, M, D, kind,
                                                   parallel, bias):
    """The tensor-core kernel (a cooperative launch, its norm after a grid
    barrier) against the plain version, bit-equal on a second call (split
    tiles and the tiles' row statistics merged in a fixed order)."""
    dt = torch.bfloat16
    ctx = _randn((B, M), 0, dt, cuda_device)
    resid = _randn((B, D), 1, dt, cuda_device, 2.0)
    wo, ws = _int8_weight((M, D), 2, cuda_device)
    bo = _randn((D,), 3, dt, cuda_device) if bias else None
    scale = _randn((D,), 4, dt, cuda_device) * 0.1 + 1
    nb = _randn((D,), 5, dt, cuda_device)
    r, h = _counted(tdec.fused_proj_norm_int8_cuda, ctx, resid, wo, ws, bo,
                    scale, nb, kind=kind, eps=1e-5, parallel=parallel)
    wr, wh = tdec._proj_norm_ref(ctx, resid, wo, bo, scale, nb, kind=kind,
                                 eps=1e-5, parallel=parallel, wscale=ws)
    _close(r, wr, GEMV_TOL[dt])
    _close(h, wh, GEMV_TOL[dt])
    again = tdec.fused_proj_norm(ctx, resid, wo, bo, scale, nb, kind=kind,
                                 eps=1e-5, parallel=parallel, wscale=ws)
    assert torch.equal(r, again[0]) and torch.equal(h, again[1])


@pytest.mark.parametrize("B", [1, 3, 8, 12])           # 12: two passes of 8
@pytest.mark.parametrize("D,F,glu,bias,act", [
    (4096, 14336, True, False, "silu"),         # llama3-8b decode
    (1600, 6400, False, True, "gelu"),          # gpt2-xl decode
    (256, 200, True, True, "gelu_exact"),       # ragged: F a multiple of 8 only
    (200, 136, False, True, "relu")])           # and D too (8-byte copies)
def test_fused_mlp_int8_kernel_matches_plain(cuda_device, B, D, F, glu, bias,
                                             act):
    """The tensor-core kernels against the plain version (``_deq``, then
    the bf16 products), bit-equal on a second call (split tiles are summed
    in a fixed order)."""
    dt = torch.bfloat16
    h = _randn((B, D), 0, dt, cuda_device)
    r = _randn((B, D), 1, dt, cuda_device)
    wu, su = _int8_weight((D, F), 2, cuda_device)
    wd, sd = _int8_weight((F, D), 3, cuda_device)
    wg, sg = _int8_weight((D, F), 4, cuda_device) if glu else (None, None)
    bu = _randn((F,), 5, dt, cuda_device) if bias else None
    bg = _randn((F,), 6, dt, cuda_device) if (glu and bias) else None
    bd = _randn((D,), 7, dt, cuda_device) if bias else None
    got = _counted(tdec.fused_mlp_int8_cuda, h, r, wu, wd, wg, (su, sg, sd),
                   bu, bg, bd, act=act)
    want = tdec._mlp_ref(h, r, wu, wg, wd, bu, bg, bd, act=act,
                         wscales=(su, sg, sd))
    _close(got, want, GEMV_TOL[dt])
    assert torch.equal(got, tdec.fused_mlp(h, r, wu, wd, wg, bu, bg, bd,
                                           act=act, wscales=(su, sg, sd)))


def _profiled_kernels(fn, want=(), sessions=4):
    """The names of the kernels a call of ``fn`` ran on the card, under
    torch.profiler, and the calls made.  On the H100 machine the profiler
    places the device's records up to a few ms off the host's clock and drops
    those it places outside its window (profiler_probe.py), so the host sleeps
    20 ms at each end of the session, as chip_smoke.py does; a session whose
    names still miss one of ``want`` is taken again, with a new call, up to
    ``sessions`` calls in all."""
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        names = [e.key for e in prof.key_averages() if e.self_device_time_total > 0]
        if all(any(w in k for k in names) for w in want):
            break
    return names, calls


def test_fused_mlp_bodies_launch_their_own_kernels(cuda_device):
    """bf16 and fp16 weights run the 16-bit tensor-core kernels and fp32
    the FFMA ones, counting on fused_mlp; int8 weights run the int8
    tensor-core kernels and count on fused_mlp_int8_cuda; none launches
    another's kernels."""
    dev, dt = cuda_device, torch.bfloat16
    h = _randn((8, 256), 0, dt, dev)
    r = _randn((8, 256), 1, dt, dev)
    wu, su = _int8_weight((256, 512), 2, dev)
    wd, sd = _int8_weight((512, 256), 3, dev)
    dense = [_randn(t.shape, 4, dt, dev, 0.05) for t in (wu, wd)]
    n16, n8 = tdec.fused_mlp.launches, tdec.fused_mlp_int8_cuda.launches
    mlp = ("mlp_act", "mlp_down")
    names, calls = _profiled_kernels(lambda: tdec.fused_mlp(h, r, *dense, act="relu"), mlp)
    assert (tdec.fused_mlp.launches, tdec.fused_mlp_int8_cuda.launches) == (n16 + calls, n8)
    assert any("mlp_act_mma_kernel" in k for k in names)
    assert any("mlp_down_mma_kernel" in k for k in names)
    assert not any("int8_mma" in k or "mlp_act_kernel" in k for k in names), names
    n16 += calls
    names, calls = _profiled_kernels(lambda: tdec.fused_mlp(
        h.half(), r.half(), *[w.half() for w in dense], act="relu"), mlp)
    assert any("mlp_act_mma_kernel" in k and "half" in k for k in names), names
    n16 += calls
    names, calls = _profiled_kernels(lambda: tdec.fused_mlp(
        h.float(), r.float(), *[w.float() for w in dense], act="relu"), mlp)
    assert any("mlp_act_kernel" in k for k in names)
    assert not any("mma" in k for k in names), names
    n16 += calls
    names, calls = _profiled_kernels(lambda: tdec.fused_mlp(
        h, r, wu, wd, act="relu", wscales=(su, None, sd)), mlp)
    assert (tdec.fused_mlp.launches, tdec.fused_mlp_int8_cuda.launches) == (n16, n8 + calls)
    assert any("mlp_act_int8_mma_kernel" in k for k in names)
    assert any("mlp_down_int8_mma_kernel" in k for k in names)
    assert not any("mlp_act_kernel" in k or "mlp_down_kernel" in k for k in names), names


def _mlp_qkv8_inputs(dev):
    """gpt2-xl's decode MLP in bf16 (the down launch split 15 ways) and
    llama3-8b's int8 QKV."""
    dt = torch.bfloat16
    mlp = dict(h=_randn((8, 1600), 0, dt, dev), r=_randn((8, 1600), 1, dt, dev),
               w_up=_randn((1600, 6400), 2, dt, dev, 1600 ** -0.5),
               w_down=_randn((6400, 1600), 3, dt, dev, 6400 ** -0.5),
               b_up=_randn((6400,), 4, dt, dev), b_down=_randn((1600,), 5, dt, dev))
    w, ws = _int8_weight((4096, 6144), 6, dev)
    qkv = (_randn((8, 4096), 7, dt, dev, 2.0), _randn((4096,), 8, dt, dev) * 0.1 + 1,
           None, w, ws)
    return mlp, qkv


def test_mlp_and_int8_qkv_launch_on_the_current_stream(cuda_device):
    """The lean host path of fused_mlp (bf16: the tensor cores, the down
    launch a programmatic dependent of the act launch) and of the int8
    fused_norm_qkv: under torch.cuda.stream(s), behind a long sleep on s,
    the inputs are written on s and the kernels read them there, with their
    scratch and tickets kept for s."""
    mlp, qkv = _mlp_qkv8_inputs(cuda_device)
    h, x = torch.zeros_like(mlp["h"]), torch.zeros_like(qkv[0])
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        h.copy_(mlp["h"])
        x.copy_(qkv[0])
        y = _counted(tdec.fused_mlp, h, mlp["r"], mlp["w_up"], mlp["w_down"],
                     b_up=mlp["b_up"], b_down=mlp["b_down"], act="gelu")
        q = _counted(tdec.fused_norm_qkv_int8_cuda, x, *qkv[1:], kind="rmsnorm",
                     eps=1e-5)
        done = s.record_event()
    done.synchronize()
    _close(y, tdec._mlp_ref(mlp["h"], mlp["r"], mlp["w_up"], None, mlp["w_down"],
                            mlp["b_up"], None, mlp["b_down"], act="gelu"),
           GEMV_TOL[torch.bfloat16])
    _close(q, tdec._norm_qkv_ref(qkv[0], qkv[1], torch.zeros_like(qkv[1]), qkv[3],
                                 None, kind="rmsnorm", eps=1e-5, wscale=qkv[4]),
           GEMV_TOL[torch.bfloat16])


def test_mlp_and_int8_qkv_replay_in_a_cuda_graph(cuda_device):
    """The launches read nothing back and leave their tickets at 0, so a
    CUDA graph captures them (the MLP's down launch with its programmatic
    dependence): a replay on new inputs equals the eager calls bit for
    bit."""
    mlp, qkv = _mlp_qkv8_inputs(cuda_device)
    h, x = mlp["h"].clone(), qkv[0].clone()

    def step():
        return (tdec.fused_mlp(h, mlp["r"], mlp["w_up"], mlp["w_down"],
                               b_up=mlp["b_up"], b_down=mlp["b_down"], act="gelu"),
                tdec.fused_norm_qkv(x, *qkv[1:4], kind="rmsnorm", eps=1e-5,
                                    wscale=qkv[4]))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()                          # scratch and tickets for s, eagerly
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        outs = step()
    h.copy_(_randn(h.shape, 9, h.dtype, cuda_device))
    x.copy_(_randn(x.shape, 10, x.dtype, cuda_device, 2.0))
    g.replay()
    torch.cuda.synchronize()
    want = step()
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)


def test_int8_proj_norm_replays_in_a_cuda_graph(cuda_device):
    """The int8 fused_proj_norm at llama3-8b's decode shape, captured in a
    CUDA graph: its launch stays cooperative (the grid barrier before the
    norm), reads nothing back and leaves its tickets at 0, so a replay on
    new inputs equals the eager call bit for bit, and a second replay the
    first."""
    dev, dt = cuda_device, torch.bfloat16
    ctx = _randn((8, 4096), 0, dt, dev)
    resid = _randn((8, 4096), 1, dt, dev, 2.0)
    wo, ws = _int8_weight((4096, 4096), 2, dev)
    scale = _randn((4096,), 3, dt, dev) * 0.1 + 1

    def step():
        return tdec.fused_proj_norm(ctx, resid, wo, None, scale, kind="rmsnorm",
                                    eps=1e-5, wscale=ws)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()                          # scratch and tickets for s, eagerly
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    launches = tdec.fused_proj_norm_int8_cuda.launches
    with torch.cuda.graph(g, stream=s):
        outs = step()
    assert tdec.fused_proj_norm_int8_cuda.launches == launches + 1
    ctx.copy_(_randn(ctx.shape, 4, dt, dev))
    resid.copy_(_randn(resid.shape, 5, dt, dev, 2.0))
    g.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in outs]
    want = step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, first))


def test_mlp_lean_path_keeps_every_refusal(cuda_device):
    """The lean test of fused_mlp falls back on the full checks, so each
    refusal raises its own error and launches nothing: the tensor cores'
    16-byte copies need 16-byte aligned activations and weights and whole
    16-byte rows; the int8 norm_qkv's copies too."""
    dev, dt = cuda_device, torch.bfloat16
    h = torch.ones(2, 64, device=dev, dtype=dt)
    w = torch.ones(64, 64, device=dev, dtype=dt)
    before = (tdec.fused_mlp.launches, tdec.fused_norm_qkv_int8_cuda.launches)
    with pytest.raises(TypeError, match="expected dtype"):
        tdec.fused_mlp(h, h.half(), w, w, act="relu")
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_mlp(torch.ones(2 * 64 + 1, device=dev, dtype=dt)[1:].view(2, 64), h,
                       w, w, act="relu")
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_mlp(h, h, torch.ones(64 * 64 + 1, device=dev, dtype=dt)[1:]
                       .view(64, 64), w, act="relu")
    with pytest.raises(ValueError, match="multiple"):
        tdec.fused_mlp(h, h, torch.ones(64, 60, device=dev, dtype=dt),
                       torch.ones(60, 64, device=dev, dtype=dt), act="relu")
    with pytest.raises(ValueError, match="shape"):
        tdec.fused_mlp(h, h, w, torch.ones(32, 64, device=dev, dtype=dt), act="relu")
    with pytest.raises(ValueError, match="expected a tensor on"):
        tdec.fused_mlp(h, h.cpu(), w, w, act="relu")
    with pytest.raises(ValueError, match="activation"):
        tdec.fused_mlp(h, h, w, w, act="swish")
    s = torch.ones(64, device=dev, dtype=dt)
    q = torch.ones(64, 64, device=dev, dtype=torch.int8)
    ws = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_norm_qkv(torch.ones(2 * 64 + 1, device=dev, dtype=dt)[1:].view(2, 64),
                            s, None, q, wscale=ws, kind="rmsnorm")
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_norm_qkv(torch.ones(2, 60, device=dev, dtype=dt),
                            torch.ones(60, device=dev, dtype=dt), None,
                            torch.ones(60, 64, device=dev, dtype=torch.int8),
                            wscale=ws, kind="rmsnorm")
    assert (tdec.fused_mlp.launches, tdec.fused_norm_qkv_int8_cuda.launches) == before


def test_int8_decode_kernels_refuse_bad_inputs(cuda_device):
    dev = cuda_device
    x = torch.ones(2, 64, device=dev, dtype=torch.bfloat16)
    s = torch.ones(64, device=dev, dtype=torch.bfloat16)
    w = torch.ones(64, 64, device=dev, dtype=torch.int8)
    ws = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        tdec.fused_norm_qkv(x.float(), s.float(), None, w, wscale=ws)
    with pytest.raises(ValueError, match="int8"):
        tdec.fused_norm_qkv(x, s, None, w.float(), wscale=ws)
    with pytest.raises(ValueError, match="scale"):
        tdec.fused_proj_norm(x, x, w, None, s, wscale=ws[:32])
    # the tensor-core proj_norm's 16-byte copies of ctx: a contraction of
    # whole 16-byte vectors, a 16-byte aligned ctx; its codes' 8-byte rows
    before = tdec.fused_proj_norm_int8_cuda.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_proj_norm(torch.ones(2, 60, device=dev, dtype=torch.bfloat16), x,
                             torch.ones(60, 64, device=dev, dtype=torch.int8), None, s,
                             wscale=ws)
    with pytest.raises(ValueError, match="aligned"):
        tdec.fused_proj_norm(torch.ones(2 * 64 + 1, device=dev, dtype=torch.bfloat16)[1:]
                             .view(2, 64), x, w, None, s, wscale=ws)
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_proj_norm(x, torch.ones(2, 60, device=dev, dtype=torch.bfloat16),
                             torch.ones(64, 60, device=dev, dtype=torch.int8), None,
                             s[:60], wscale=ws[:60])
    assert tdec.fused_proj_norm_int8_cuda.launches == before
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.fused_mlp(x, x, torch.ones(64, 60, device=dev, dtype=torch.int8),
                       torch.ones(60, 64, device=dev, dtype=torch.int8),
                       act="relu", wscales=(ws[:60], None, ws))


def _generate_both(model, cfg, prompts, dev, n=12, **kw):
    import deepspeed_tpu_torch

    outs = []
    for d in ("cpu", dev):
        eng = deepspeed_tpu_torch.init_inference(model, cfg, device=d)
        outs.append(eng.generate(prompts, max_new_tokens=n, **kw).cpu())
    return outs


@pytest.mark.parametrize("preset", ["llama-tiny", "gpt2-small"])
@pytest.mark.parametrize("dtype,fused", [("float32", True), ("float32", False),
                                         ("int8", True)])
def test_generate_on_card_matches_cpu(cuda_device, preset, dtype, fused):
    """init_inference(...).generate() of a small model on the card (the
    contiguous flash_decode and the GEMV kernels, int8 bodies included) and
    on the CPU (their plain versions): the same greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    over = (dict(num_layers=2, hidden_size=256, intermediate_size=512,
                 num_kv_heads=2, vocab_size=1024) if preset == "llama-tiny"
            else dict(num_layers=2, hidden_size=256, intermediate_size=1024,
                      num_heads=4, vocab_size=1024, max_seq_len=512))
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", **over)
    with torch.no_grad():
        if model.config.position == "learned":
            model.embed.tok.mul_(16.0)
            model.embed.pos.mul_(80.0)
        else:
            model.embed.tok.mul_(40.0)
    cfg = {"dtype": dtype, "max_out_tokens": 300}
    if not fused:
        cfg["use_fused_decode"] = False
    prompts = np.random.default_rng(0).integers(0, 1024, (3, 70))
    contig = tdec.flash_decode_contig_cuda.launches
    got_cpu, got_card = _generate_both(model, cfg, prompts, cuda_device)
    assert (tdec.flash_decode_contig_cuda.launches > contig) == fused
    assert torch.equal(got_cpu, got_card)


SMALL_SERVE = {
    "llama-tiny": dict(num_layers=2, hidden_size=256, intermediate_size=512,
                       num_kv_heads=2, vocab_size=1024),
    "gpt2-small": dict(num_layers=2, hidden_size=256, intermediate_size=1024,
                       num_heads=4, vocab_size=1024, max_seq_len=512),
    "mixtral-tiny": dict(num_layers=2, hidden_size=256, intermediate_size=512,
                         num_kv_heads=2, vocab_size=1024)}


def _small_serving_model(preset):
    import deepspeed_tpu_torch

    model = deepspeed_tpu_torch.causal_lm(preset, device="cpu",
                                          **SMALL_SERVE[preset])
    with torch.no_grad():
        if model.config.position == "learned":
            model.embed.tok.mul_(16.0)
            model.embed.pos.mul_(80.0)
        else:
            model.embed.tok.mul_(40.0)
    return model


def _serve_both(model, cfg, waves, dev):
    import deepspeed_tpu_torch

    outs = []
    for d in ("cpu", dev):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=d,
                                                 num_slots=2, prefill_chunk=32)
        got = []
        for wave in waves:
            reqs = [serve.submit(p, max_new_tokens=16) for p in wave]
            serve.run()
            got += [(r.output_tokens, r.prefix_hit_tokens) for r in reqs]
        outs.append(got)
    return outs


SERVE_VARIANTS = [("llama-tiny", {"paged_kv_cache": False}),
                  ("llama-tiny", {"paged_kv_cache": False,
                                  "use_fused_decode": False}),
                  ("gpt2-small", {"paged_kv_cache": False}),
                  ("llama-tiny", {"quantize_kv_cache": True}),
                  ("llama-tiny", {"quantize_kv_cache": True,
                                  "paged_kv_cache": False}),
                  ("mixtral-tiny", {}), ("mixtral-tiny", {"paged_kv_cache": False})]


@pytest.mark.parametrize("preset,over", SERVE_VARIANTS)
def test_serving_variants_on_card_match_cpu(cuda_device, preset, over):
    """The fixed-slot layout (fused: the contiguous flash_decode at per-row
    positions), the int8 KV cache and the MoE MLP, serving a small fp32
    model on the card and on the CPU: the same greedy tokens and prefix
    hits (a second wave repeats a prompt)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_serving_model(preset)
    cfg = {"dtype": "float32", "max_out_tokens": 300, "kv_page_tokens": 64,
           **over}
    prompts = [np.random.default_rng(i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    contig = tdec.flash_decode_contig_cuda.launches
    cpu, card = _serve_both(model, cfg, [prompts, prompts[2:]], cuda_device)
    assert cpu == card
    fused = (preset != "mixtral-tiny" and not over.get("quantize_kv_cache")
             and over.get("use_fused_decode", True))
    fixed = over.get("paged_kv_cache") is False
    assert (tdec.flash_decode_contig_cuda.launches > contig) == (fused and fixed)


@pytest.mark.parametrize("preset,over", [("llama-tiny", {"quantize_kv_cache": True}),
                                         ("mixtral-tiny", {})])
def test_int8_kv_and_moe_generate_on_card_match_cpu(cuda_device, preset, over):
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_serving_model(preset)
    cfg = {"dtype": "float32", "max_out_tokens": 300, **over}
    prompts = np.random.default_rng(0).integers(0, 1024, (3, 70))
    got_cpu, got_card = _generate_both(model, cfg, prompts, cuda_device)
    assert torch.equal(got_cpu, got_card)


def test_moe_mlp_on_card_matches_cpu(cuda_device):
    """moe_mlp at mixtral-8x7b's width, 8 rows (a decode step): bf16 on the
    card against the CPU, the routing (fp32 router, TF32 off) equal, the
    output within 2e-2."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.moe import sharded_moe as tmoe

    D, F, E = 4096, 1024, 8
    cfg = SimpleNamespace(num_experts=E, num_experts_per_tok=2,
                          moe_capacity_factor=1.25, moe_dispatch="scatter",
                          activation="silu", glu=True)
    gen = torch.Generator().manual_seed(0)
    p = {"gate_w": torch.rand(D, E, generator=gen) * 0.03,
         "w_up": torch.randn(E, D, F, generator=gen) * 0.02,
         "w_gate": torch.randn(E, D, F, generator=gen) * 0.02,
         "w_down": torch.randn(E, F, D, generator=gen) * 0.03}
    x = torch.randn(8, 1, D, generator=gen)
    p = {k: v.bfloat16() for k, v in p.items()}
    x = x.bfloat16()
    want, aux_cpu = tmoe.moe_mlp(p, x, cfg)
    got, aux = tmoe.moe_mlp({k: v.to(cuda_device) for k, v in p.items()},
                            x.to(cuda_device), cfg)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    g_cpu = tmoe.router_gates(x.reshape(8, D), p["gate_w"])
    g_card = tmoe.router_gates(x.reshape(8, D).to(cuda_device),
                               p["gate_w"].to(cuda_device))
    for a, b in zip(tmoe.topk_assignments(g_cpu, 2, 4)[:2],
                    tmoe.topk_assignments(g_card, 2, 4)[:2]):
        assert torch.equal(a, b.cpu())
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5


def test_unmodified_llama_tiny_trains_on_card(cuda_device):
    """The llama-tiny preset as it is (D 256, 8 heads of 32, 4 layers,
    vocab 32000) trained 3 steps on the card (flash at Dh 32) and on the
    CPU: losses within rtol 1e-4 and weights within atol 1e-4, the bounds
    of test_training_on_card_matches_cpu."""
    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = []
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu")
        assert model.config.head_dim == 32
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        before = tfa.flash_attention.launches
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        assert (tfa.flash_attention.launches > before) == (dev != "cpu")
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lg[-1] < lg[0]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_mixtral_tiny_trains_on_card(cuda_device):
    """The mixtral-tiny preset as it is (D 256, 8 heads of 32, 4 layers, 8
    experts top-2, vocab 32000) trained 3 steps on the card and on the CPU:
    the loss with its aux term within rtol 1e-4 and weights within atol
    1e-4, the bounds of test_unmodified_llama_tiny_trains_on_card; the card
    run launches the flash kernels and the RMSNorm backward."""
    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = []
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("mixtral-tiny", device="cpu")
        assert model.config.is_moe and model.config.head_dim == 32
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        before = (tfa.flash_attention.launches, tln.rms_norm_bwd.launches)
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        after = (tfa.flash_attention.launches, tln.rms_norm_bwd.launches)
        assert all((a > b) == (dev != "cpu") for a, b in zip(after, before))
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lg[-1] < lg[0]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def _hf_config(tmp_path, name, hf):
    """A HF config.json alone (the card has no transformers; the weights
    are random from a seed)."""
    import json

    from deepspeed_tpu_torch.module_inject import config_from_hf

    path = tmp_path / name
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf))
    return config_from_hf(str(path))


# a tiny BLOOM (ALiBi, 12 heads of 32: slopes that interpolate, the
# embedding LayerNorm, biases) and a tiny GPT-NeoX (parallel residual,
# rotary_pct 0.25, 4 heads of 64), each through config_from_hf
TINY_HF = {
    "bloom": {"model_type": "bloom", "hidden_size": 384, "n_layer": 2,
              "n_head": 12, "vocab_size": 512, "seq_length": 256},
    "gpt_neox": {"model_type": "gpt_neox", "hidden_size": 256,
                 "intermediate_size": 512, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "vocab_size": 512,
                 "max_position_embeddings": 256, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "hidden_act": "gelu"}}


@pytest.mark.parametrize("arch", sorted(TINY_HF))
def test_hf_families_train_on_card_like_cpu(cuda_device, tmp_path, arch):
    """A tiny BLOOM and a tiny GPT-NeoX, trained 3 fp32 steps on the card
    (the flash kernels, ALiBi's for BLOOM) and on the CPU from the same
    weights: the bounds of test_training_on_card_matches_cpu."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    mcfg = _hf_config(tmp_path, arch, TINY_HF[arch])
    alibi = arch == "bloom"
    counter = tfa.flash_fwd_alibi_cuda if alibi else tfa.flash_attention
    tok = np.random.default_rng(0).integers(0, 512, (4, 200))
    runs = []
    for dev in ("cpu", cuda_device):
        model = CausalLM(mcfg, device="cpu", seed=0)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        before = counter.launches
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        assert (counter.launches > before) == (dev != "cpu")
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert lg[-1] < lg[0]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints: tags cross between the card and the CPU, and resume bit-equal
# ---------------------------------------------------------------------------

CKPT_CONFIGS = {
    "FusedAdam": {"optimizer": {"type": "FusedAdam", "params": {
        "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}}},
    "Adam8bit": {"optimizer": {"type": "Adam8bit", "params": {
        "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}}},
    "master_free_adam8bit": {
        "optimizer": {"type": "Adam8bit", "params": {
            "lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        "bf16": {"enabled": True, "master_weights": False},
        "data_types": {"grad_accum_dtype": "bf16"}},
}


def _ckpt_engine(name, dev):
    """A 2-layer llama (head dim 32, the flash kernels' smallest) under one
    of CKPT_CONFIGS, random weights from seed 0, on ``dev``."""
    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-3, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0, **CKPT_CONFIGS[name]}
    model = deepspeed_tpu_torch.causal_lm(
        "llama-tiny", device="cpu", num_layers=2, hidden_size=64,
        intermediate_size=128, num_heads=2, num_kv_heads=1, vocab_size=256,
        seed=0)
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, device=dev)[0]


def _ckpt_tokens(seed):
    return np.random.default_rng(seed).integers(0, 256, (4, 64))


def _engine_state(eng):
    """Every leaf a save writes, by key, on the CPU."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import (
        keystr, tree_flatten_with_path)

    tree = {"model": eng._nest(eng.master), "optim": eng._optim_payload()}
    return {keystr(k): v.detach().cpu().clone()
            for k, v in tree_flatten_with_path(tree)}


def _assert_states_bit_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", list(CKPT_CONFIGS))
@pytest.mark.parametrize("saver", ["card", "cpu"])
def test_checkpoint_crosses_between_card_and_cpu(cuda_device, tmp_path, name,
                                                 saver):
    """A tag saved by a card engine loads into a CPU engine with every
    master, moment, code, scale and counter bit-equal, and the reverse."""
    devs = {"card": cuda_device, "cpu": "cpu"}
    loader = "cpu" if saver == "card" else "card"
    a = _ckpt_engine(name, devs[saver])
    for i in range(2):
        tok = _ckpt_tokens(i)
        a.train_step((tok, tok))
    a.save_checkpoint(str(tmp_path))
    b = _ckpt_engine(name, devs[loader])
    assert b.load_checkpoint(str(tmp_path))[0] == str(tmp_path / "global_step2")
    assert all(p.device.type == torch.device(devs[loader]).type for p in b.master)
    _assert_states_bit_equal(_engine_state(b), _engine_state(a))
    assert b.optimizer.count == a.optimizer.count == 2


@pytest.mark.parametrize("name", list(CKPT_CONFIGS))
def test_checkpoint_resume_on_card_is_bit_equal(cuda_device, tmp_path, name):
    """A card engine resumed from its own tag takes the next steps
    bit-equal to the uninterrupted engine, through the fused Adam or
    Adam8bit kernel (its count and stochastic-rounding seed restored)."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit_update, fused_adam_update

    kernel = fused_adam_update if name == "FusedAdam" else fused_adam8bit_update
    a = _ckpt_engine(name, cuda_device)
    for i in range(2):
        tok = _ckpt_tokens(i)
        a.train_step((tok, tok))
    a.save_checkpoint(str(tmp_path))
    b = _ckpt_engine(name, cuda_device)
    b.load_checkpoint(str(tmp_path))
    runs = []
    for eng in (a, b):
        before = kernel.launches
        steps = []
        for i in range(2, 4):
            tok = _ckpt_tokens(i)
            steps.append((float(eng.train_step((tok, tok))),
                          eng.get_global_grad_norm()))
        assert kernel.launches > before
        runs.append((steps, _engine_state(eng)))
    assert runs[1][0] == runs[0][0]
    _assert_states_bit_equal(runs[1][1], runs[0][1])


def test_checkpoint_bf16_leaves_read_back_bit_equal(cuda_device, tmp_path):
    """bf16 tensors on the card (normals, subnormals, infinities, a NaN,
    signed zeros) go through the shard file as raw 2-byte words."""
    import json

    from deepspeed_tpu_torch.runtime.checkpoint_engine import ShardedCheckpointEngine

    words = torch.from_numpy(np.random.default_rng(0).integers(
        -2**15, 2**15, (3, 1000), dtype=np.int16))
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -3.0], dtype=torch.bfloat16)
    tree = {"a": words.view(torch.bfloat16).to(cuda_device),
            "b": special.to(cuda_device),
            "c": torch.tensor(1.5, dtype=torch.bfloat16, device=cuda_device)}
    eng = ShardedCheckpointEngine()
    eng.save(tree, str(tmp_path))
    with open(tmp_path / "index_p0.json") as fh:
        assert {m["dtype"] for m in json.load(fh).values()} == {"bfloat16"}
    back = eng.load(str(tmp_path))
    for key, want in (("['a']", tree["a"]), ("['b']", tree["b"]), ("['c']", tree["c"])):
        got = back[key]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.cpu().view(torch.int16)), key


# ---------------------------------------------------------------------------
# dropout (csrc/dropout.cu), the offloaded-dots remat, the new optimizers
# ---------------------------------------------------------------------------

DROPOUT_SHAPES = [(4, 2048, 2048), (3, 5, 7, 9), (1000003,), (0, 8), (33, 17)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", DROPOUT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dropout_kernel_matches_plain_bit_for_bit(cuda_device, dtype, shape, rate):
    """The kernel's forward and backward equal the plain version on the
    card bit for bit (the same threefry bits, the same product rounded
    once): [4, 2048, 2048] is llama-1b4's training shape, (1000003,) and
    (33, 17) leave a tail past the last 16-byte vector, (0, 8) is empty."""
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop
    from deepspeed_tpu_torch.utils import prng

    key = prng.prng_key(17)
    x = _randn(shape, 0, dtype, cuda_device, 3.0)
    n = (tdrop.dropout.launches, tdrop.dropout_bwd.launches)
    y = tdrop.dropout_cuda(x, key, rate)
    dx = tdrop.dropout_bwd_cuda(x, key, rate)
    torch.cuda.synchronize()
    plain = tdrop.dropout_plain(x, key, rate)
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, plain) and torch.equal(dx, plain)
    empty = x.numel() == 0
    assert (tdrop.dropout.launches, tdrop.dropout_bwd.launches) == (
        n[0] + (not empty), n[1] + (not empty))


def test_dropout_kernel_reads_a_non_contiguous_view_by_its_logical_index(cuda_device):
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop
    from deepspeed_tpu_torch.utils import prng

    x = _randn((64, 130), 1, torch.bfloat16, cuda_device)
    for view in (x.t(), x[:, 1:]):                 # transposed, unaligned
        key = prng.prng_key(3)
        assert torch.equal(tdrop.dropout_cuda(view, key, 0.1),
                           tdrop.dropout_plain(view.contiguous(), key, 0.1))


def test_dropout_autograd_launches_the_forward_and_the_backward(cuda_device):
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop
    from deepspeed_tpu_torch.utils import prng

    x = _randn((8, 1024), 2, torch.bfloat16, cuda_device).requires_grad_()
    n = (tdrop.dropout.launches, tdrop.dropout_bwd.launches)
    y = tdrop.dropout(x, prng.prng_key(5), 0.1)
    y.float().sum().backward()
    assert (tdrop.dropout.launches, tdrop.dropout_bwd.launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(x.grad, tdrop.dropout_plain(torch.ones_like(x), prng.prng_key(5), 0.1))


def test_dropout_replays_in_a_cuda_graph(cuda_device):
    """No read-back and no host sync: a captured launch replays to the
    eager call's bits, on new inputs copied into the captured buffer."""
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop
    from deepspeed_tpu_torch.utils import prng

    key = prng.prng_key(9)
    x = _randn((4, 512, 1024), 3, torch.bfloat16, cuda_device)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tdrop.dropout_cuda(x, key, 0.1)            # warm up off the capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = tdrop.dropout_cuda(x, key, 0.1)
    for seed in (4, 5):
        x.copy_(_randn(x.shape, seed, x.dtype, cuda_device))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, tdrop.dropout_plain(x, key, 0.1))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_kernel_keeps_within_binomial_bounds(cuda_device, rate):
    """At [4, 2048, 2048] the kept share is within 6 standard deviations of
    1 - rate (n = 16.8M: sd 7.3e-5 at 0.1), and each kept value is x times
    the scale."""
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop
    from deepspeed_tpu_torch.utils import prng

    x = torch.ones((4, 2048, 2048), device=cuda_device, dtype=torch.bfloat16)
    y = tdrop.dropout_cuda(x, prng.prng_key(2024), rate)
    n = x.numel()
    kept = float((y != 0).sum()) / n
    p = 1.0 - rate
    assert abs(kept - p) <= 6 * (p * (1 - p) / n) ** 0.5
    scale = torch.tensor(tdrop.dropout_scale(torch.bfloat16, rate)).to(torch.bfloat16)
    assert set(torch.unique(y).tolist()) == {0.0, float(scale)}


def _tiny_train_cfg(opt="FusedAdam", params=None, **over):
    """The card tests' train config: WarmupLR up to the optimizer's lr."""
    params = params or {"lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt, "params": params},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_max_lr": params["lr"], "warmup_num_steps": 2}},
            "gradient_clipping": 1.0, **over}


@pytest.mark.parametrize("policy", ["mlp_dots", "offload_dots"])
def test_dropout_llama_tiny_trains_on_card(cuda_device, policy):
    """llama-tiny as it is with dropout 0.1, 3 steps on the card and on the
    CPU: the masks are the same on both devices, so the bounds of
    test_unmodified_llama_tiny_trains_on_card hold (losses rtol 1e-4,
    weights atol 1e-4); the card run launches both dropout kernels."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import dropout as tdrop

    torch.backends.cuda.matmul.allow_tf32 = False
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = []
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                              dropout=0.1, remat=True,
                                              remat_policy=policy)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                    config=_tiny_train_cfg(),
                                                    device=dev)
        before = (tdrop.dropout.launches, tdrop.dropout_bwd.launches)
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        after = (tdrop.dropout.launches, tdrop.dropout_bwd.launches)
        assert all((a > b) == (dev != "cpu") for a, b in zip(after, before))
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("over", [{}, {"dropout": 0.1},
                                  {"parallel_residual": True}])
def test_offload_dots_grads_equal_no_remat_on_card(cuda_device, over):
    """``offload_dots`` keeps each layer's matmul outputs in pinned host
    memory and replays them: loss and gradients bit-equal to no remat on
    the card, in bf16."""
    from deepspeed_tpu_torch.models import causal_lm
    from deepspeed_tpu_torch.utils import prng

    model = causal_lm("llama-tiny", device=cuda_device, dtype=torch.bfloat16,
                      num_layers=3, **over)
    params = model.params()
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32000, (2, 128))).to(cuda_device)
    out = []
    for remat, policy in ((False, "full"), (True, "offload_dots")):
        model.config.remat, model.config.remat_policy = remat, policy
        leaves = {}

        def copy(t, path=""):
            if isinstance(t, dict):
                return {k: copy(v, f"{path}.{k}") for k, v in t.items()}
            leaves[path] = t.detach().clone().requires_grad_()
            return leaves[path]
        tp = copy(params)
        loss = model.apply(tp, tok, tok, rngs=prng.prng_key(7))
        loss.backward()
        out.append((loss.detach(), {k: v.grad for k, v in leaves.items()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("opt,params", [
    ("Lion", {"lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1}),
    ("Adagrad", {"lr": 1e-2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("Muon", {"lr": 2e-3, "weight_decay": 0.1})])
def test_new_optimizers_train_on_card_like_cpu(cuda_device, opt, params):
    """llama-tiny 3 steps under each optimizer on the card and on the CPU:
    losses rtol 1e-4, weights atol 1e-4 (Lion's sign may flip where its sum
    is within rounding of zero: at most 0.1 % of the weights, by 2 lr)."""
    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = []
    for dev in ("cpu", cuda_device):
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=_tiny_train_cfg(opt, params), device=dev)
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        runs.append((losses, [p.cpu() for p in engine.master]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(pc, pg):
        d = (b - a).abs()
        if opt == "Lion":
            assert float(d.max()) <= 2.02 * params["lr"]
            assert float((d > 1e-4).float().mean()) <= 1e-3
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# ZeRO-Offload of the optimizer state: the relay and the offloading engine
# ---------------------------------------------------------------------------

def test_offload_relay_reuses_pinned_staging_only_after_its_copy_landed(cuda_device):
    """Eight 64 MiB leaves through a pool of two pinned H2D buffers: each
    buffer is handed out again only once the copy that last read it has
    landed (its event has fired), and every leaf arrives on the card with
    the bytes written for it, though the host fills the next buffer at
    once.  The D2H staging is pinned too, and each grad arrives whole."""
    from deepspeed_tpu_torch.runtime.zero.relay import OffloadRelay

    n, leaves = 1 << 24, 8
    relay = OffloadRelay([n] * leaves, torch.float32, torch.float32, cuda_device)
    grads = [torch.full((n,), float(i), device=cuda_device) for i in range(leaves)]
    dst = [torch.empty(n, device=cuda_device) for _ in range(leaves)]
    relay.grads_to_host(grads)
    for i in range(leaves):
        g = relay.grad(i)
        assert g.is_pinned() and bool((g == i).all())
        out = relay.out_buffer(i)
        assert out.is_pinned()
        out.fill_(float(100 + i))
        relay.params_to_device(i, out, dst[i])
    relay.finish()
    torch.cuda.synchronize()
    assert len(relay.reuse_log) == leaves - 2
    assert [(slot, last) for slot, last, _, _ in relay.reuse_log] == [
        (i % 2, i - 2) for i in range(2, leaves)]
    assert all(after for *_, after in relay.reuse_log)
    for i in range(leaves):
        assert bool((dst[i] == 100 + i).all()), i
    ms = relay.device_ms()
    assert ms["d2h_ms"] > 0 and ms["h2d_ms"] > 0


@pytest.mark.parametrize("section", [
    {"bf16": {"enabled": False}},
    {"bf16": {"enabled": True}},
    {"bf16": {"enabled": False}, "backend": "nvme"}])
def test_offload_step_on_card_equals_the_cpu_port(cuda_device, section, tmp_path):
    """llama-tiny with ``offload_optimizer`` on the card and on the CPU:
    fp32 three steps within the train gates' bounds (losses rtol 1e-4, host
    masters atol 1e-4), bf16 two steps (WarmupLR's first lr is 0) within
    the bf16 bounds (loss 1e-3, host masters 1e-2), the nvme backend as the
    cpu one; the engine adds to the card only the compute-dtype params and
    the accumulator."""
    import gc

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    section = dict(section)
    backend = section.pop("backend", "cpu")
    off = {"device": backend}
    if backend == "nvme":
        off["nvme_path"] = str(tmp_path / "swap")
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": 0, "offload_optimizer": off}, **section}
    bf16 = cfg["bf16"]["enabled"]
    steps = 2 if bf16 else 3
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = []
    # cuBLAS's workspaces and the kernels' cached scratch are made at their
    # first use and kept: one step of an engine without offload makes them
    # before the count, so that the count sees the offloading engine alone
    plain = {k: v for k, v in cfg.items() if k != "zero_optimization"}
    warm, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu"),
        config=plain, device=cuda_device)
    warm.train_step((tok, tok))
    del warm
    for dev in ("cpu", cuda_device):
        gc.collect()
        before = torch.cuda.memory_allocated(cuda_device)
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        losses = [float(engine.train_step((tok, tok))) for _ in range(steps)]
        runs.append((losses, [m.clone() for m in engine._offload_opt.masters()]))
        if dev != "cpu":
            held = sum(t.numel() * t.element_size()
                       for t in engine.master + engine.grad_acc)
            # the fp32 masters alone would be 2 (bf16) or 1 (fp32) times
            # the params' bytes more; a few MiB of small tensors (the loss,
            # the scale, the norm) may stay
            assert torch.cuda.memory_allocated(cuda_device) - before <= held + (8 << 20)
            assert all(p.is_cuda and p.dtype == engine.compute_dtype
                       for p in engine.master)
            assert all(not m.is_cuda for m in runs[-1][1])
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-3 if bf16 else 1e-4)
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-2 if bf16 else 1e-4)


# ---------------------------------------------------------------------------
# ZeRO-Infinity (offload_param): the parameter streamer and the streamed step
# ---------------------------------------------------------------------------

def _stacked_host(layers, n, dtype):
    """A stacked ``[L, n]`` host leaf page-locked as the engine's host copy
    is, each layer filled with its index."""
    from deepspeed_tpu_torch.runtime.zero.relay import PinnedBlock

    block = PinnedBlock(layers * n * dtype.itemsize)
    t = block.view(0, layers * n, dtype).view(layers, n)
    for i in range(layers):
        t[i].fill_(float(i + 1))
    return block, t


@pytest.mark.parametrize("prefetch", [True, False])
def test_param_streamer_reuses_a_slot_only_after_its_readers_event(cuda_device, prefetch):
    """Eight 32 MiB layers through two slots, each read by a long chain of
    kernels on the compute stream: every copy that reuses a slot starts
    after the event its last reader recorded (device timestamps), each
    payload holds its own layer's bytes when its reader runs, and with
    prefetch every take finds its layer in flight (without, every take
    misses)."""
    from deepspeed_tpu_torch.runtime.zero.streaming import ParamStreamer

    L, n = 8, 1 << 24
    block, host = _stacked_host(L, n, torch.bfloat16)
    st = ParamStreamer(cuda_device, prefetch=prefetch, staging_slots=2)
    st.refresh({"w": host})
    sums = []
    st.prefetch(0)
    for i in range(L):
        if i + 1 < L:
            st.prefetch(i + 1)
        lp = st.take(i)
        w = st.materialize(lp)["w"]
        acc = w.float()
        for _ in range(8):             # a reader that takes a while
            acc = acc * 1.0 + 0.0
        sums.append(acc.sum())
        st.release(lp)
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [float((i + 1) * n) for i in range(L)]
    gaps = st.reuse_gaps_ms()
    assert len(gaps) == len(st.reuse_log) == L - 2 and min(gaps) >= 0
    assert [(slot, old) for slot, old, *_ in st.reuse_log] == [
        (i % 2, i - 2) for i in range(2, L)]
    if prefetch:
        assert (st.prefetch_hits, st.prefetch_misses) == (L, 0)
    else:
        assert (st.prefetch_hits, st.prefetch_misses) == (0, L)
    assert st.h2d_bytes == L * n * 2 and st.stall_seconds() >= 0
    del block


def test_streamed_step_leaves_no_param_or_grad_on_the_card(cuda_device):
    """llama-tiny with ``offload_param`` on the card and on the CPU, fp32,
    three steps: losses within rtol 1e-4 and host masters within atol 1e-4
    (the train gates' bounds); the card holds no param, grad or
    accumulator: the params and the accumulators are host tensors, and
    after each step the card holds only the streamer's slots (a few MiB of
    small tensors allowed, after a warm-up step of an engine without
    offload made cuBLAS's workspaces and the kernels' scratch)."""
    import gc

    import deepspeed_tpu_torch

    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
           "gradient_clipping": 1.0}
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    warm, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu"),
        config=cfg, device=cuda_device)
    warm.train_step((tok, tok))
    del warm
    cfg["zero_optimization"] = {"stage": 0, "offload_param": {"device": "cpu"}}
    runs = []
    for dev in ("cpu", cuda_device):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=dev)
        losses = []
        for _ in range(3):
            losses.append(float(engine.train_step((tok, tok))))
            if dev != "cpu":
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated(cuda_device) - before
                assert held <= engine._streamed.streamer.slot_bytes() + (8 << 20)
        assert not any(t.is_cuda for t in engine.master + engine.grad_acc)
        assert all(float(a.abs().max()) == 0 for a in engine.grad_acc)
        runs.append((losses, [m.clone() for m in engine._offload_opt.masters()]))
    (lc, pc), (lg, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_zero_stages_over_nccl_at_world_one_equal_stage_0(cuda_device, tmp_path):
    """ZeRO stages 1-3 over a world-one NCCL group (a ``FileStore``, no
    socket) on llama-tiny in fp32: three steps bit-equal to stage 0 on the
    plain path (losses, grad norms, masters), the collectives run at every
    stage (nothing short-circuits at world 1), the fused Adam kernel steps
    every leaf's slice, ``engine.params()`` gathers the full leaves."""
    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "FusedAdam", "params": {
               "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
           "gradient_clipping": 1.0}
    tok = np.random.default_rng(0).integers(0, 32000, (4, 96))
    runs = {}
    try:
        for stage in (0, 1, 2, 3):
            if stage == 1:
                comm.init_distributed(device=cuda_device, rank=0, world_size=1,
                                      store=dist.FileStore(str(tmp_path / "store"), 1))
            model = deepspeed_tpu_torch.causal_lm("llama-tiny", device=cuda_device)
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=model, device=cuda_device, config=dict(
                    cfg, zero_optimization={"stage": stage,
                                            "stage3_param_persistence_threshold": 0}))
            comm.reset_counters()
            before = tadam.fused_adam_update.launches
            steps = [(float(engine.train_step((tok, tok))), engine.get_global_grad_norm())
                     for _ in range(3)]
            assert tadam.fused_adam_update.launches - before == 3 * len(engine.master)
            params = {k: v.clone() for k, v in _flat_params(engine.params())}
            runs[stage] = (steps, params, comm.counters(), engine)
            if stage:
                assert engine._dist and runs[stage][2]["all_reduce"]["calls"] > 0
                assert (stage >= 2) == ("reduce_scatter" in runs[stage][2])
                assert steps == runs[0][0], stage
                for k, v in params.items():
                    assert torch.equal(v, runs[0][1][k]), (stage, k)
                    assert tuple(v.shape) == tuple(runs[0][1][k].shape)
        assert any(p.param for p in runs[3][3]._plan)
        assert not runs[0][3]._dist and not runs[0][2]
    finally:
        comm.destroy()


def _flat_params(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat_params(tree[k], path)
        else:
            yield path, tree[k]


# ---------------------------------------------------------------------------
# the quantized collectives' codec (csrc/comm_quant.cu)
# ---------------------------------------------------------------------------

CODEC_CASES = [((24, 2048, 128), 256, 4), ((1000003,), 256, 1), ((33, 17), 200, 1),
               ((4, 999), 64, 4), ((8, 1000), 7, 2), ((0,), 256, 1)]


@pytest.mark.parametrize("shape,block,rows", CODEC_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_comm_quant_kernels_match_plain_bit_for_bit(cuda_device, dtype, shape, block, rows):
    """The quantizer and the dequantizer (sum, concatenation with each
    row's padding stripped, and the error form) equal their plain versions
    on the card bit for bit, on the register path (block 256 over rows of
    whole 16-byte vectors) and the scalar one (a tail, odd blocks, an
    unaligned view), with a zero block; one launch a call."""
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    x = _randn(shape, 7, torch.float32, cuda_device, 2.0).reshape(-1)
    x[:block] = 0.0
    x = x.to(dtype)
    views = [x] + ([x[1:1 + (x.numel() - 1) // rows * rows]] if x.numel() > rows else [])
    for v in views:
        n0 = (kq.quantize_blockwise.launches, kq.dequantize_blockwise.launches)
        q, s = kq.quantize_blockwise_cuda(v, block, rows)
        qp, sp = kq.quantize_blockwise_plain(v, block, rows)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        keep = v.numel() // rows
        outs = [(True, torch.float32), (False, dtype), (False, torch.float32)]
        for add, odt in outs:
            assert torch.equal(kq.dequantize_blockwise_cuda(q, s, keep, add, odt),
                               kq.dequantize_blockwise_plain(q, s, keep, add, odt))
        base = v.float().contiguous()
        assert torch.equal(kq.dequantize_error_cuda(base, q, s),
                           kq.dequantize_error_plain(base, q, s))
        launched = v.numel() > 0
        assert (kq.quantize_blockwise.launches, kq.dequantize_blockwise.launches) == (
            n0[0] + launched, n0[1] + 4 * launched)


def test_comm_quant_collectives_at_world_one_on_card(cuda_device):
    """``q_all_gather_flat`` and ``q_reduce_scatter_flat`` over a world-one
    NCCL group quantize (as the JAX functions do at one rank) through the
    kernels: each the plain codec's round trip of its input."""
    import tempfile

    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import collectives_q as cq
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.kernels import comm_quant as kq

    with tempfile.TemporaryDirectory() as root:
        comm.init_distributed(device="cuda", store=dist.FileStore(f"{root}/s", 1),
                              rank=0, world_size=1, verbose=False)
        try:
            g = _randn((3, 4096), 9, torch.float32, cuda_device).reshape(-1)
            w = g.to(torch.bfloat16)
            n0 = kq.quantize_blockwise.launches
            got_g = cq.q_all_gather_flat(w, None)
            got_r = cq.q_reduce_scatter_flat(g, None)
            assert kq.quantize_blockwise.launches == n0 + 2
            q, s = kq.quantize_blockwise_plain(w, 256)
            assert torch.equal(got_g, kq.dequantize_blockwise_plain(q, s, w.numel()))
            q, s = kq.quantize_blockwise_plain(g, 256)
            assert torch.equal(got_r, kq.dequantize_blockwise_plain(q, s, g.numel(), True))
        finally:
            comm.destroy()
