"""The port's fused decode kernels and decode step against the JAX package.

On the CPU each wrapper of ``deepspeed_tpu_torch/ops/kernels/decode.py``
runs its plain version; the JAX side runs its jnp reference
(``impl="xla"``) and its Pallas kernel in interpret mode
(``impl="interpret"``).  Inputs come from numpy with a seed.

Tolerances: fp32 2e-5 for the projections (fp32 sums of up to 512
products in another order, the bound tests/unit/test_fused_decode.py holds
the Pallas kernels to; 1e-4 at gpt2-xl's width, sums of 1600 products, as
the card tests hold the kernels) and 2e-4 for attention (an online softmax
against a dense one, as there); bf16 2e-2 (one bf16 rounding of each
output, and of the normalised rows or the activation before a product);
fp16 2.5e-3, the bf16 bound over 8 (fp16 keeps three more mantissa bits:
one rounding of each output is at most 2^-11 relative, and a normalised
row rounded to fp16 before the product moves a sum by about one fp16 ulp
of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import causal_lm as j_causal_lm
from deepspeed_tpu.models import fused_decode as jfd
from deepspeed_tpu.ops.pallas import decode as jdec
from deepspeed_tpu_torch.models import causal_lm as t_causal_lm
from deepspeed_tpu_torch.models import fused_decode as tfd
from deepspeed_tpu_torch.models import jax_params_to_torch
from deepspeed_tpu_torch.ops.kernels import decode as tdec
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
WIDE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def _pair(a, dtype):
    """The same numpy array on both sides (None stays None)."""
    if a is None:
        return None, None
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               t.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_norm_qkv_matches_jax(impl, dtype, kind, with_bias):
    rng = np.random.default_rng(0)
    B, D, N = 3, 256, 384
    x = _rand(rng, B, D, scale=2.0)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    w = _rand(rng, D, N, scale=0.1)
    bq = _rand(rng, N) if with_bias else None
    (jx, tx), (js, ts), (jb, tb) = (_pair(x, dtype), _pair(scale, dtype),
                                    _pair(bias, dtype))
    (jw, tw), (jq, tq) = _pair(w, dtype), _pair(bq, dtype)
    want = jdec.fused_norm_qkv(jx, js, jb, jw, jq, kind=kind, eps=1e-5,
                               impl=impl)
    got = tdec.fused_norm_qkv(tx, ts, tb, tw, tq, kind=kind, eps=1e-5)
    assert got.dtype == TDT[dtype] and got.shape == (B, N)
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind,parallel", [("rmsnorm", False),
                                           ("layernorm", False),
                                           ("rmsnorm", True),
                                           ("layernorm", True)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_proj_norm_matches_jax(impl, dtype, kind, parallel, with_bias):
    rng = np.random.default_rng(1)
    B, M, D = 3, 192, 256
    ctx = _rand(rng, B, M)
    resid = _rand(rng, B, D, scale=2.0)
    wo = _rand(rng, M, D, scale=0.1)
    bo = _rand(rng, D) if with_bias else None
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    args = [_pair(a, dtype) for a in (ctx, resid, wo, bo, scale, bias)]
    jr, jh = jdec.fused_proj_norm(*[a[0] for a in args], kind=kind, eps=1e-5,
                                  parallel=parallel, impl=impl)
    tr, th = tdec.fused_proj_norm(*[a[1] for a in args], kind=kind, eps=1e-5,
                                  parallel=parallel)
    assert tr.dtype == th.dtype == TDT[dtype]
    _close(jr, tr, TOL[dtype])
    _close(jh, th, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_qkv_matches_jax_at_gpt2_xl_width(dtype):
    """gpt2-xl's decode step: 8 rows of 1600, LayerNorm with a bias, the QKV
    bias."""
    rng = np.random.default_rng(2)
    B, D, N = 8, 1600, 4800
    x = _rand(rng, B, D, scale=2.0)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    w = _rand(rng, D, N, scale=D ** -0.5)
    bq = _rand(rng, N)
    args = [_pair(a, dtype) for a in (x, scale, bias, w, bq)]
    want = jdec.fused_norm_qkv(*[a[0] for a in args], kind="layernorm",
                               eps=1e-5, impl="xla")
    got = tdec.fused_norm_qkv(*[a[1] for a in args], kind="layernorm",
                              eps=1e-5)
    _close(want, got, WIDE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_proj_norm_matches_jax_at_gpt2_xl_width(dtype):
    """gpt2-xl's out-projection and MLP norm: ctx [8, 1600] @ [1600, 1600],
    the projection's bias, LayerNorm with a bias."""
    rng = np.random.default_rng(3)
    B, M, D = 8, 1600, 1600
    ctx = _rand(rng, B, M)
    resid = _rand(rng, B, D, scale=2.0)
    wo = _rand(rng, M, D, scale=M ** -0.5)
    bo = _rand(rng, D)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    args = [_pair(a, dtype) for a in (ctx, resid, wo, bo, scale, bias)]
    jr, jh = jdec.fused_proj_norm(*[a[0] for a in args], kind="layernorm",
                                  eps=1e-5, parallel=False, impl="xla")
    tr, th = tdec.fused_proj_norm(*[a[1] for a in args], kind="layernorm",
                                  eps=1e-5, parallel=False)
    _close(jr, tr, WIDE_TOL[dtype])
    _close(jh, th, WIDE_TOL[dtype])


def _mlp_inputs(rng, B, D, F, glu, with_bias):
    h = _rand(rng, B, D)
    r = _rand(rng, B, D)
    w_up = _rand(rng, D, F, scale=0.2)
    w_down = _rand(rng, F, D, scale=0.1)
    w_gate = _rand(rng, D, F, scale=0.2) if glu else None
    b_up = _rand(rng, F) if with_bias else None
    b_gate = _rand(rng, F) if (glu and with_bias) else None
    b_down = _rand(rng, D) if with_bias else None
    return h, r, w_up, w_down, w_gate, b_up, b_gate, b_down


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_mlp_matches_jax(impl, dtype, glu, with_bias):
    rng = np.random.default_rng(2)
    act = "silu" if glu else "gelu"
    args = [_pair(a, dtype)
            for a in _mlp_inputs(rng, 3, 128, 512, glu, with_bias)]
    want = jdec.fused_mlp(*[a[0] for a in args], act=act, impl=impl)
    got = tdec.fused_mlp(*[a[1] for a in args], act=act)
    assert got.dtype == TDT[dtype] and got.shape == (3, 128)
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_exact", "relu"])
def test_fused_mlp_activations_match_jax(impl, act):
    rng = np.random.default_rng(3)
    args = [_pair(a, "float32")
            for a in _mlp_inputs(rng, 2, 128, 256, True, False)]
    want = jdec.fused_mlp(*[a[0] for a in args], act=act, impl=impl)
    got = tdec.fused_mlp(*[a[1] for a in args], act=act)
    _close(want, got, TOL["float32"])


def test_fused_mlp_biases_are_independent():
    """The port holds each bias on its own, as the jnp reference does: with
    no ``b_up`` the gate and down biases still apply (the Pallas kernel
    gates all three on ``b_up``; ROADMAP.md queue 3)."""
    rng = np.random.default_rng(4)
    h, r, w_up, w_down, w_gate, _, b_gate, b_down = _mlp_inputs(
        rng, 2, 128, 256, True, True)
    args = [_pair(a, "float32")
            for a in (h, r, w_up, w_down, w_gate, None, b_gate, b_down)]
    want = jdec._mlp_ref(*[args[i][0] for i in (0, 1, 2, 4, 3, 5, 6, 7)],
                         act="silu")
    got = tdec.fused_mlp(*[a[1] for a in args], act="silu")
    _close(want, got, TOL["float32"])
    no_bias = tdec.fused_mlp(*[a[1] for a in args[:5]], act="silu")
    assert (got - no_bias).abs().max() > 1e-2


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,D,F,glu,act,with_bias", [
    (8, 1600, 6400, False, "gelu", True),    # gpt2-xl's decode MLP
    (8, 256, 200, True, "silu", False),      # gated, F a multiple of 8 only
    (12, 136, 328, True, "silu", True)])     # two passes, D off the stage
def test_fused_mlp_matches_jax_at_path_widths(impl, dtype, B, D, F, glu, act,
                                              with_bias):
    """The plain version the card tests hold the tensor-core MLP to, in the
    two 16-bit dtypes, at gpt2-xl's widths and at ragged ones (F not a
    multiple of the kernels' 64-column tiles, D not one of their stages),
    weights scaled as the models' init.  bf16 2e-2 and fp16 2.5e-3 (the
    module's bounds: one rounding of the output and of ``a``; sums of up to
    6400 products in another order move fp32 by far less)."""
    rng = np.random.default_rng(7)
    h = _rand(rng, B, D)
    r = _rand(rng, B, D)
    w_up = _rand(rng, D, F, scale=D ** -0.5)
    w_gate = _rand(rng, D, F, scale=D ** -0.5) if glu else None
    w_down = _rand(rng, F, D, scale=F ** -0.5)
    b_up = _rand(rng, F) if with_bias else None
    b_gate = _rand(rng, F) if (glu and with_bias) else None
    b_down = _rand(rng, D) if with_bias else None
    args = [_pair(a, dtype)
            for a in (h, r, w_up, w_down, w_gate, b_up, b_gate, b_down)]
    want = jdec.fused_mlp(*[a[0] for a in args], act=act, impl=impl)
    got = tdec.fused_mlp(*[a[1] for a in args], act=act)
    assert got.dtype == TDT[dtype] and got.shape == (B, D)
    _close(want, got, TOL[dtype])


def _paged_pool(rng, L, B, Hkv, page, maxp, Dh):
    """A stacked [L, P, Hkv, page, Dh] pool behind a shuffled page table
    (page 0 is the junk page and is never assigned)."""
    P = B * maxp + 1
    k = _rand(rng, L, P, Hkv, page, Dh)
    v = _rand(rng, L, P, Hkv, page, Dh)
    table = (rng.permutation(B * maxp) + 1).reshape(B, maxp)
    return k, v, table


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [[127, 128], [5, 300], [383, 0]])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_decode_paged_matches_jax(impl, dtype, pos, alibi):
    """GQA (2 query heads per KV head) over a stacked two-layer pool with a
    shuffled page table and per-row depths at page boundaries; 128-token
    pages, the smallest the Pallas kernel takes in interpret mode."""
    rng = np.random.default_rng(5)
    L, B, Hkv, rep, Dh, page, maxp = 2, 2, 2, 2, 32, 128, 3
    q = _rand(rng, B, Hkv * rep, Dh)
    k, v, table = _paged_pool(rng, L, B, Hkv, page, maxp, Dh)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), \
        _pair(v, dtype)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
    jt, tt = jnp.asarray(table, jnp.int32), torch.from_numpy(table)
    for layer in range(L):
        want = jdec.flash_decode(jq, jk, jv, jpos, layer=layer, alibi=alibi,
                                 page_table=jt, impl=impl)
        got = tdec.flash_decode(tq, tk, tv, tpos, layer=layer, alibi=alibi,
                                page_table=tt)
        assert got.dtype == TDT[dtype] and got.shape == tq.shape
        _close(want, got, ATTN_TOL[dtype])


@pytest.mark.parametrize("page,pos", [(16, [15, 16, 47]), (64, [0, 63, 191])])
def test_flash_decode_small_pages_match_jax(page, pos):
    """Pages below 128 tokens (the port's pools use 8-256): the JAX package
    takes its gathered dense reference for them; unpaged layer=None pool."""
    rng = np.random.default_rng(6)
    B, Hkv, rep, Dh, maxp = 3, 2, 4, 16, 3
    q = _rand(rng, B, Hkv * rep, Dh)
    k, v, table = _paged_pool(rng, 1, B, Hkv, page, maxp, Dh)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(q, "float32"),
                                    _pair(k[0], "float32"),
                                    _pair(v[0], "float32"))
    want = jdec.flash_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32),
                             page_table=jnp.asarray(table, jnp.int32),
                             impl="xla")
    got = tdec.flash_decode(tq, tk, tv, torch.tensor(pos),
                            page_table=torch.from_numpy(table))
    _close(want, got, ATTN_TOL["float32"])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 77, [127, 3], [64, 100]])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_decode_contig_matches_jax(impl, dtype, pos, alibi):
    """The contiguous cache of generate(): GQA (4 query heads per KV head)
    over a stacked two-layer [L, B, Hkv, Smax, Dh] cache read at each layer,
    one depth for the batch (an int) or one a row.  Smax 128 is a multiple
    of the 64-token block passed, so interpret mode runs the Pallas kernel;
    the port takes any block (the CUDA kernel has none)."""
    rng = np.random.default_rng(8)
    L, B, Hkv, rep, Dh, Smax = 2, 2, 2, 4, 32, 128
    q = _rand(rng, B, Hkv * rep, Dh)
    k = _rand(rng, L, B, Hkv, Smax, Dh)
    v = _rand(rng, L, B, Hkv, Smax, Dh)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), \
        _pair(v, dtype)
    if isinstance(pos, list):
        jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
    else:
        jpos, tpos = jnp.asarray(pos, jnp.int32), pos
    for layer in range(L):
        want = jdec.flash_decode(jq, jk, jv, jpos, layer=layer, alibi=alibi,
                                 block=64, impl=impl)
        got = tdec.flash_decode(tq, tk, tv, tpos, layer=layer, alibi=alibi,
                                block=64)
        assert got.dtype == TDT[dtype] and got.shape == tq.shape
        _close(want, got, ATTN_TOL[dtype])


@pytest.mark.parametrize("Smax,pos", [(100, [99, 0, 41]), (1025, 1024)])
def test_flash_decode_contig_any_length_matches_jax(Smax, pos):
    """Cache lengths the Pallas kernel does not tile (the JAX package takes
    its dense reference for them), an unstacked cache (layer=None), MHA."""
    rng = np.random.default_rng(9)
    B, H, Dh = 3, 4, 16
    q = _rand(rng, B, H, Dh)
    k = _rand(rng, B, H, Smax, Dh)
    v = _rand(rng, B, H, Smax, Dh)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(q, "float32"), _pair(k, "float32"),
                                    _pair(v, "float32"))
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = jdec.flash_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32))
    _close(want, tdec.flash_decode(tq, tk, tv, tpos), ATTN_TOL["float32"])


# ---------------------------------------------------------------------------
# flash_decode's grid: the chunk and split arithmetic the kernel follows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Dh,itemsize,chunk", [
    (128, 2, 64), (64, 2, 128), (256, 2, 32), (128, 4, 32), (256, 4, 16),
    (64, 4, 64), (8, 2, 128), (40, 2, 128), (32, 4, 128)])
def test_fd_chunk_by_head_dim_and_dtype(Dh, itemsize, chunk):
    """16 to 128 keys (a power of two: threads a key for the scores), the
    chunk's K rows within 16 KB."""
    c = tdec.fd_chunk(Dh, itemsize)
    assert c == chunk and c & (c - 1) == 0 and 16 <= c <= 128
    assert c * Dh * itemsize <= tdec._FD_CHUNK_BYTES or c == 16


# blocks an H100 holds at once at llama3-8b's decode shape: 3 an SM on 132
SLOTS = 3 * 132


@pytest.mark.parametrize("B,Hkv,rep,Dh,itemsize,keys,chunk,splits", [
    (8, 8, 4, 128, 2, 264, 64, 5),       # llama3-8b generate: 320 blocks
    (8, 8, 4, 128, 2, 2048, 64, 6),      # 2048 keys: one wave, 384 blocks
    (8, 8, 4, 128, 2, 1024, 64, 6),      # the serve pool's bound (4 x 256)
    (8, 25, 1, 64, 2, 1024, 128, 1),     # gpt2-xl serve: 200 rows fill it
    (8, 8, 4, 128, 2, 1, 64, 1),         # depth 1: one block a row
    (1, 8, 4, 128, 4, 2048, 32, 49),     # one row, fp32
    (1, 1, 8, 64, 2, 65536, 128, 256),   # the cap on blocks a row
    (600, 8, 4, 128, 2, 512, 64, 1)])    # more rows than the card holds
def test_fd_plan_fills_one_wave(B, Hkv, rep, Dh, itemsize, keys, chunk,
                                splits):
    """As many splits as fit one wave of resident blocks, never more than
    the chunks."""
    c, s, nbytes = tdec.fd_plan(B, Hkv, rep, Dh, itemsize, keys, SLOTS)
    assert (c, s) == (chunk, splits)
    chunks = -(-keys // c)
    assert s <= chunks and s <= tdec._FD_MAX_SPLITS
    rows = min(B, tdec._FD_MAX_ROWS // Hkv) * Hkv
    assert rows * s <= max(SLOTS, rows)                  # one wave
    assert s == min(chunks, tdec._FD_MAX_SPLITS) or rows * (s + 1) > SLOTS
    assert nbytes == (rows * s * rep * (Dh + 2) * 4 if s > 1 else 0)


def test_fd_plan_passes_keep_a_ticket_a_row():
    """More (slot, KV head) rows than tickets: the scratch and the tickets
    cover one pass of _FD_MAX_ROWS rows."""
    c, s, nbytes = tdec.fd_plan(1024, 8, 4, 128, 2, 8192, SLOTS)
    assert s == 1 and nbytes == 0
    c, s, nbytes = tdec.fd_plan(600, 8, 1, 64, 2, 8192, 3 * 4096)
    assert s == 3 and nbytes == 512 * 8 * s * 1 * 66 * 4


@pytest.mark.parametrize("page", [8, 16, 256])
@pytest.mark.parametrize("Smax", [64, 512, 1025])
@pytest.mark.parametrize("itemsize,Dh", [(2, 128), (4, 128), (2, 64)])
def test_fd_every_key_in_exactly_one_chunk(page, Smax, itemsize, Dh):
    """Per-row depths 1..Smax (pos 0..Smax-1, and a pos past the window)
    over a paged pool of Smax // page + 1 pages a slot: every key 0..pos of
    every row falls in exactly one split's chunks, no split reads past the
    row's depth, and each chunk's page-table entries fit the kernel's slot
    of ``chunk`` entries within the table row."""
    maxp = Smax // page + 1
    bound = maxp * page
    rng = np.random.default_rng(Smax + page)
    depths = sorted({0, 1, 15, 16, 17, Smax - 1, bound - 1, bound + 7,
                     *rng.integers(0, Smax, 8).tolist()})
    for slots in (1, SLOTS):
        chunk, splits, _ = tdec.fd_plan(len(depths), 8, 4, Dh, itemsize,
                                        bound, slots)
        for pos in depths:
            n_tok = min(pos + 1, bound)
            seen = np.zeros(n_tok, np.int64)
            ranges = tdec.fd_split_keys(n_tok, chunk, splits)
            assert 1 <= len(ranges) <= splits
            for start, end in ranges:
                assert start % chunk == 0 and start < end <= n_tok
                seen[start:end] += 1
                for c in range(start // chunk, -(-end // chunk)):
                    p0, p1 = tdec.fd_chunk_pages(c, chunk, page, maxp)
                    assert 0 <= p0 < p1 <= maxp and p1 - p0 <= chunk
                    assert p0 <= c * chunk // page
                    assert (min(end, (c + 1) * chunk) - 1) // page < p1
            assert (seen == 1).all()
        assert tdec.fd_split_keys(0, chunk, splits) == []


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fd_shared_memory_bounded(itemsize):
    """Every head dim (a multiple of 8 up to 256) and GQA group (1 to 8)
    fits a block's shared memory, which holds no term in Smax or maxp."""
    for Dh in range(8, 257, 8):
        chunk = tdec.fd_chunk(Dh, itemsize)
        for rep in range(1, 9):
            assert tdec.fd_smem_bytes(Dh, rep, chunk, itemsize) <= \
                tdec._SMEM_LIMIT


def _split_merge(q, k, v, pos, scale, chunk, splits, alibi):
    """The kernel's algorithm in fp32 torch over a contiguous [B, Hkv, S,
    Dh] cache: each live split's online softmax over its chunks, then the
    ordered merge of the splits' (acc, m, l)."""
    from deepspeed_tpu_torch.models.layers import alibi_slopes

    B, H, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    out = torch.zeros(B, H, Dh)
    slopes = alibi_slopes(H).reshape(Hkv, rep)
    for b in range(B):
        n_tok = min(int(pos[b]) + 1, S)
        for g in range(Hkv):
            qg = q[b, g * rep:(g + 1) * rep].float()
            parts = []
            for start, end in tdec.fd_split_keys(n_tok, chunk, splits):
                m = torch.full((rep,), tdec.NEG_INF)
                l, acc = torch.zeros(rep), torch.zeros(rep, Dh)
                for c0 in range(start, end, chunk):
                    t = torch.arange(c0, c0 + chunk)
                    kk = k[b, g, c0:c0 + chunk].float()
                    vv = v[b, g, c0:c0 + chunk].float()
                    s = (qg @ kk.T) * scale
                    if alibi:
                        s = s + slopes[g][:, None] * (t[:len(kk)] - int(pos[b]))
                    s = torch.where(t[None, :len(kk)] < n_tok, s, tdec.NEG_INF)
                    mn = torch.maximum(m, s.max(-1).values)
                    p = torch.exp(s - mn[:, None])
                    al = torch.exp(m - mn)
                    l, acc, m = al * l + p.sum(-1), acc * al[:, None] + p @ vv, mn
                parts.append((acc, m, l))
            M = torch.stack([m for _, m, _ in parts]).max(0).values
            L = sum(torch.exp(m - M) * l for _, m, l in parts)
            O = sum(torch.exp(m - M)[:, None] * a for a, m, _ in parts)
            out[b, g * rep:(g + 1) * rep] = O / L[:, None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("alibi", [False, True])
def test_fd_split_and_ordered_merge_match_jax(splits, alibi):
    """The kernel's split of each row's keys over blocks and its ordered
    merge, in fp32 torch, against the JAX package's flash_decode: depths at
    chunk edges (C - 1, C, C + 1 keys), one key, and a full cache."""
    rng = np.random.default_rng(10)
    B, Hkv, rep, Dh, S, chunk = 6, 2, 4, 32, 80, 16
    q = _rand(rng, B, Hkv * rep, Dh)
    k = _rand(rng, B, Hkv, S, Dh)
    v = _rand(rng, B, Hkv, S, Dh)
    pos = [14, 15, 16, 0, 47, S - 1]
    want = jdec.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32), alibi=alibi)
    got = _split_merge(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), pos, Dh ** -0.5, chunk, splits,
                       alibi)
    _close(want, got, ATTN_TOL["float32"])


def _g16_grid(K, N, tn, cap):
    """csrc/decode.cu ``g16_grid``: (tiles, k16 steps, blocks, k16 steps a
    split, even, slots) of a [K, N] product over ``tn``-column tiles and
    ``cap`` resident blocks."""
    tiles, k16 = -(-N // tn), -(-K // 16)
    if tiles > cap:
        units = tiles * k16
        blocks = min(cap, units)
        fewest = units // blocks
        return tiles, k16, blocks, 0, True, -(-k16 // fewest) + 1
    want = max(1, min(k16, cap // tiles))
    sps = -(-k16 // want)
    slots = -(-k16 // sps)
    return tiles, k16, tiles * slots, sps, False, slots


@pytest.mark.parametrize("K,N,tn,cap,tiles,slots,blocks", [
    (14336, 4096, 64, 396, 64, 6, 384),     # llama3-8b's down launch
    (6400, 1600, 64, 396, 25, 15, 375),     # gpt2-xl's
    (4096, 14336, 64, 396, 224, 1, 224),    # llama3-8b's act launch
    (1600, 6400, 64, 396, 100, 3, 300),     # gpt2-xl's
    (4096, 6144, 128, 396, 48, 8, 384)])    # the int8 norm_qkv's
def test_g16_grid_splits_the_contraction(K, N, tn, cap, tiles, slots,
                                         blocks):
    """The split grid at the paths' shapes (132 SMs x 3 blocks): a split
    only where the column tiles are fewer than the resident blocks, every
    k16 step of a tile in exactly one split."""
    t, k16, b, sps, even, sl = _g16_grid(K, N, tn, cap)
    assert (t, sl, b, even) == (tiles, slots, blocks, False)
    assert b <= cap
    steps = [u for s in range(sl) for u in range(s * sps, min(k16, (s + 1) * sps))]
    assert steps == list(range(k16))


def _split_down(a, w_down, b_down, r, sps, tn):
    """The down launch's algorithm in torch, as the kernel orders it: each
    tile's split of the contraction (``sps`` k16 steps of rows of ``a``)
    summed into an fp32 partial, the partials summed in split order, then
    the bias and the residual, rounded to r's dtype."""
    F, D = w_down.shape
    out = torch.empty(r.shape, dtype=r.dtype)
    for n0 in range(0, D, tn):
        cols = slice(n0, min(D, n0 + tn))
        total = torch.zeros(r.shape[0], cols.stop - n0)
        for k0 in range(0, F, sps * 16):
            rows = slice(k0, min(F, k0 + sps * 16))
            total = total + a[:, rows].float() @ w_down[rows, cols].float()
        if b_down is not None:
            total = total + b_down[cols].float()
        out[:, cols] = (r[:, cols].float() + total).to(r.dtype)
    return out


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("D,F,cap", [(1600, 6400, 396),   # gpt2-xl: 15 splits
                                     (256, 200, 12)])     # a ragged last split
def test_mlp_down_split_and_ordered_merge_match_jax(impl, dtype, D, F, cap):
    """The MLP's two launches as the kernels cut them: ``a`` rounded to the
    activation dtype between them, then the down launch's contraction split
    over blocks (``g16_grid``) and merged in split order, against the JAX
    package's fused_mlp (tanh-GeLU, biases).  The module's 16-bit bounds."""
    rng = np.random.default_rng(14)
    B = 8
    h, r = _rand(rng, B, D), _rand(rng, B, D)
    w_up = _rand(rng, D, F, scale=D ** -0.5)
    w_down = _rand(rng, F, D, scale=F ** -0.5)
    b_up, b_down = _rand(rng, F), _rand(rng, D)
    args = [_pair(x, dtype) for x in (h, r, w_up, w_down, None, b_up, None,
                                      b_down)]
    want = jdec.fused_mlp(*[x[0] for x in args], act="gelu", impl=impl)
    th, tr, twu, twd, _, tbu, _, tbd = [x[1] for x in args]
    a = torch.nn.functional.gelu(th.float() @ twu.float() + tbu.float(),
                                 approximate="tanh").to(TDT[dtype])
    sps = _g16_grid(F, D, 64, cap)[3]
    got = _split_down(a, twd, tbd, tr, sps, 64)
    _close(want, got, TOL[dtype])


def _int8(rng, d_in, d_out):
    """int8 codes and per-column fp32 scales, as quantize_weight makes
    them (the same arrays go to both packages)."""
    q = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)
    s = (np.abs(rng.standard_normal(d_out)) * 0.02 / 127 + 1e-4)
    return q, s.astype(np.float32)


def _q8_pair(q, s):
    return ((jnp.asarray(q), jnp.asarray(s)),
            (torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_norm_qkv_int8_matches_jax(impl, kind, with_bias):
    """int8 codes with per-column scales, dequantized to bf16 in the
    kernel (``_deq``): bf16 tolerance."""
    rng = np.random.default_rng(10)
    B, D, N = 3, 256, 384
    x = _rand(rng, B, D, scale=2.0)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    bq = _rand(rng, N) if with_bias else None
    (jw, jws), (tw, tws) = _q8_pair(*_int8(rng, D, N))
    (jx, tx), (js, ts), (jb, tb) = (_pair(x, "bfloat16"),
                                    _pair(scale, "bfloat16"),
                                    _pair(bias, "bfloat16"))
    jq, tq = _pair(bq, "bfloat16")
    want = jdec.fused_norm_qkv(jx, js, jb, jw, jq, kind=kind, eps=1e-5,
                               wscale=jws, impl=impl)
    got = tdec.fused_norm_qkv(tx, ts, tb, tw, tq, kind=kind, eps=1e-5,
                              wscale=tws)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N)
    _close(want, got, TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("B,D,N", [(3, 256, 200),    # 8-byte rows: cp.async
                                   (5, 136, 264),    # D off the 128-row stage
                                   (8, 1600, 4800),  # gpt2-xl: a half last tile
                                   (12, 256, 392)])  # two passes of 8
def test_fused_norm_qkv_int8_ragged_matches_jax(impl, kind, B, D, N):
    """The int8 norm_qkv's plain version at column counts that are no
    multiple of the tensor-core kernel's 128-column tiles (and, where N is
    no multiple of 16, rows the TMA cannot address), against JAX: bf16
    tolerance."""
    rng = np.random.default_rng(13)
    x = _rand(rng, B, D, scale=2.0)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    bq = _rand(rng, N)
    (jw, jws), (tw, tws) = _q8_pair(*_int8(rng, D, N))
    (jx, tx), (js, ts), (jb, tb), (jq, tq) = (
        _pair(a, "bfloat16") for a in (x, scale, bias, bq))
    want = jdec.fused_norm_qkv(jx, js, jb, jw, jq, kind=kind, eps=1e-5,
                               wscale=jws, impl=impl)
    got = tdec.fused_norm_qkv(tx, ts, tb, tw, tq, kind=kind, eps=1e-5,
                              wscale=tws)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N)
    _close(want, got, TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("kind,parallel", [("rmsnorm", False),
                                           ("layernorm", True)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_proj_norm_int8_matches_jax(impl, kind, parallel, with_bias):
    rng = np.random.default_rng(11)
    B, M, D = 3, 256, 128
    ctx = _rand(rng, B, M)
    resid = _rand(rng, B, D, scale=2.0)
    bo = _rand(rng, D) if with_bias else None
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    (jw, jws), (tw, tws) = _q8_pair(*_int8(rng, M, D))
    (jc, tc), (jr, tr), (jo, to) = (_pair(ctx, "bfloat16"),
                                    _pair(resid, "bfloat16"),
                                    _pair(bo, "bfloat16"))
    (js, ts), (jb, tb) = _pair(scale, "bfloat16"), _pair(bias, "bfloat16")
    wr, wh = jdec.fused_proj_norm(jc, jr, jw, jo, js, jb, kind=kind, eps=1e-5,
                                  parallel=parallel, wscale=jws, impl=impl)
    r, h = tdec.fused_proj_norm(tc, tr, tw, to, ts, tb, kind=kind, eps=1e-5,
                                parallel=parallel, wscale=tws)
    _close(wr, r, TOL["bfloat16"])
    _close(wh, h, TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("B,M,D", [(12, 256, 392),    # two passes of 8
                                   (3, 256, 200),     # 8-byte rows: cp.async
                                   (5, 136, 264),     # M off the 128-row stage
                                   (8, 1600, 1600)])  # gpt2-xl: a half last tile
def test_fused_proj_norm_int8_ragged_matches_jax(impl, kind, B, M, D):
    """The int8 proj_norm's plain version at the shapes its tensor-core
    kernel treats apart (a second pass of 8 rows, code rows the TMA cannot
    address, a contraction off the ring's stage, a 128-column tile half
    full), against JAX: bf16 tolerance."""
    rng = np.random.default_rng(15)
    ctx = _rand(rng, B, M)
    resid = _rand(rng, B, D, scale=2.0)
    bo = _rand(rng, D)
    scale = 1.0 + _rand(rng, D, scale=0.1)
    bias = _rand(rng, D)
    (jw, jws), (tw, tws) = _q8_pair(*_int8(rng, M, D))
    (jc, tc), (jr, tr), (jo, to), (js, ts), (jb, tb) = (
        _pair(a, "bfloat16") for a in (ctx, resid, bo, scale, bias))
    wr, wh = jdec.fused_proj_norm(jc, jr, jw, jo, js, jb, kind=kind, eps=1e-5,
                                  parallel=False, wscale=jws, impl=impl)
    r, h = tdec.fused_proj_norm(tc, tr, tw, to, ts, tb, kind=kind, eps=1e-5,
                                parallel=False, wscale=tws)
    assert r.dtype == h.dtype == torch.bfloat16 and r.shape == h.shape == (B, D)
    _close(wr, r, TOL["bfloat16"])
    _close(wh, h, TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B,F", [(3, 256), (1, 256), (8, 256), (12, 256),
                                 (3, 200)])
def test_fused_mlp_int8_matches_jax(impl, glu, act, with_bias, B, F):
    """(up, gate, down) codes and scales; the gate's scale is None without
    a gate, as the JAX engine passes it.  The rows the card tests give the
    tensor-core kernels (1, a pass of 8, 12 = two passes) and a ragged F (a
    multiple of 8 only), so the plain version those tests hold the kernels
    to is itself held to the JAX ``fused_mlp``."""
    rng = np.random.default_rng(12)
    D = 128
    h = _rand(rng, B, D)
    r = _rand(rng, B, D)
    (jwu, jsu), (twu, tsu) = _q8_pair(*_int8(rng, D, F))
    (jwd, jsd), (twd, tsd) = _q8_pair(*_int8(rng, F, D))
    if glu:
        (jwg, jsg), (twg, tsg) = _q8_pair(*_int8(rng, D, F))
    else:
        jwg = jsg = twg = tsg = None
    bu = _rand(rng, F) if with_bias else None
    bg = _rand(rng, F) if (with_bias and glu) else None
    bd = _rand(rng, D) if with_bias else None
    (jh, th), (jr, tr) = _pair(h, "bfloat16"), _pair(r, "bfloat16")
    (jbu, tbu), (jbg, tbg), (jbd, tbd) = (_pair(bu, "bfloat16"),
                                          _pair(bg, "bfloat16"),
                                          _pair(bd, "bfloat16"))
    want = jdec.fused_mlp(jh, jr, jwu, jwd, jwg, jbu, jbg, jbd, act=act,
                          wscales=(jsu, jsg, jsd), impl=impl)
    got = tdec.fused_mlp(th, tr, twu, twd, twg, tbu, tbg, tbd, act=act,
                         wscales=(tsu, tsg, tsd))
    assert got.dtype == torch.bfloat16
    _close(want, got, TOL["bfloat16"])


def test_cpu_calls_count_no_launch():
    counters = (tdec.fused_norm_qkv, tdec.flash_decode, tdec.fused_proj_norm,
                tdec.fused_mlp, tdec.flash_decode_contig_cuda,
                tdec.fused_norm_qkv_int8_cuda, tdec.fused_proj_norm_int8_cuda,
                tdec.fused_mlp_int8_cuda)
    before = [f.launches for f in counters]
    x = torch.ones(2, 16)
    w = torch.ones(16, 16)
    tdec.fused_norm_qkv(x, torch.ones(16), None, w, kind="rmsnorm")
    tdec.fused_proj_norm(x, x, w, None, torch.ones(16), kind="rmsnorm")
    tdec.fused_mlp(x, x, w, w, act="relu")
    xb, wq, ws = x.bfloat16(), w.to(torch.int8), torch.ones(16)
    tdec.fused_norm_qkv(xb, xb[0], None, wq, kind="rmsnorm", wscale=ws)
    tdec.fused_mlp(xb, xb, wq, wq, act="relu", wscales=(ws, None, ws))
    tdec.flash_decode(torch.ones(2, 4, 8), torch.ones(2, 2, 9, 8),
                      torch.ones(2, 2, 9, 8), 5)
    after = [f.launches for f in counters]
    assert after == before


# ---------------------------------------------------------------------------
# decode_step on one tiny model
# ---------------------------------------------------------------------------

DTINY = dict(num_layers=2, hidden_size=128, intermediate_size=256,
             num_heads=4, num_kv_heads=2, vocab_size=256, max_seq_len=1024)


@pytest.fixture(scope="module")
def tiny():
    jm = j_causal_lm("llama-tiny", remat=False, **DTINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = t_causal_lm("llama-tiny", device="cpu", **DTINY)
    tp = jax_params_to_torch(jax.tree.map(np.asarray, params), tm.config,
                             device="cpu")
    return jm, params, tm, tp


def test_inject_decode_params_matches_jax_and_views_the_tree(tiny):
    jm, params, tm, tp = tiny
    jd = jfd.inject_decode_params(params, jm.config)
    td = tfd.inject_decode_params(tp, tm.config)
    assert len(td["layers"]) == len(jd["layers"]) == DTINY["num_layers"]
    for jl, tl in zip(jd["layers"], td["layers"]):
        assert sorted(jl) == sorted(tl)
        for name in jl:
            np.testing.assert_array_equal(np.asarray(jl[name]),
                                          tl[name].numpy(), err_msg=name)
    # every per-layer leaf but the concatenated QKV is a view of the tree
    for l, lp in enumerate(td["layers"]):
        assert lp["wo"].data_ptr() == tp["layers"]["attn"]["wo"][l].data_ptr()
        assert lp["w_up"].data_ptr() == tp["layers"]["mlp"]["w_up"][l].data_ptr()
        assert lp["wqkv"].is_contiguous()
    assert td["embed"] is tp["embed"]
    assert tfd.supports_fused_decode(tm.config)
    assert not tfd.supports_fused_decode(tm.config, quantized_kv=True)
    assert not tfd.supports_fused_decode(tm.config, tp=2)


def test_decode_step_matches_jax_interpret(tiny):
    """Three paged decode steps (page 128, shuffled table, a parked row on
    the junk page) through the JAX decode_step with the Pallas kernels in
    interpret mode and through the port's: logits within 2e-4 (fp32,
    attention tolerance); the pools equal within 2e-5 on every live page
    (each new K/V row is a projection and a rotation computed in another
    order) and bit for bit on every row neither side wrote."""
    jm, params, tm, tp = tiny
    cfg = jm.config
    jd = jfd.inject_decode_params(params, cfg)
    td = tfd.inject_decode_params(tp, tm.config)
    rng = np.random.default_rng(7)
    L, Hkv, Dh, page, maxp = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        128, 3
    table = np.zeros((3, maxp), np.int64)
    table[0] = [3, 1, 5]
    table[1, :2] = [6, 2]                  # row 2 parked on the junk page
    k = _rand(rng, L, 7, Hkv, page, Dh)
    v = _rand(rng, L, 7, Hkv, page, Dh)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    pos = np.array([254, 127, 0])
    tok = np.array([[3], [99], [0]])
    for _ in range(3):
        jl, jc = jfd.decode_step(cfg, jd, jnp.asarray(tok), jc,
                                 jnp.asarray(pos, jnp.int32),
                                 page_table=jnp.asarray(table, jnp.int32),
                                 impl="interpret")
        tl, tc = tfd.decode_step(tm.config, td, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos),
                                 page_table=torch.from_numpy(table))
        assert tl.dtype == torch.float32 and tl.shape == (3, 256)
        np.testing.assert_allclose(np.asarray(jl)[:2], tl[:2].numpy(),
                                   rtol=2e-4, atol=2e-4)
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        tok[2] = 0
        pos[:2] += 1
    written = np.zeros(k.shape[1:4], bool)          # [P, Hkv, page]
    for b, p0 in ((0, 254), (1, 127)):
        for p in range(p0, p0 + 3):
            written[table[b, p // page], :, p % page] = True
    for name in ("k", "v"):
        j, t = np.asarray(jc[name]), tc[name].numpy()
        np.testing.assert_allclose(j[:, 1:], t[:, 1:], rtol=2e-5, atol=2e-5)
        keep = ~written
        keep[0] = False                              # the junk page
        np.testing.assert_array_equal(j[:, keep], t[:, keep])


def test_decode_step_refuses_unported_branches(tiny):
    """Every cache layout of the JAX function is ported; what JAX refuses
    the port refuses too (a paged pool at one scalar position), and the
    int8 KV cache raises naming the ROADMAP."""
    _, _, tm, tp = tiny
    td = tfd.inject_decode_params(tp, tm.config)
    cache = {"k": torch.zeros(2, 3, 2, 16, 32), "v": torch.zeros(2, 3, 2, 16, 32)}
    tok = torch.zeros(2, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="per-row positions"):
        tfd.decode_step(tm.config, td, tok, cache, 5,
                        page_table=torch.zeros(2, 3, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfd.decode_step(tm.config, td, tok,
                        dict(cache, k_scale=torch.zeros(2, 3, 2, 16, 1)), 5)
