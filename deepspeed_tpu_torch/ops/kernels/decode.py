"""Fused per-layer decode kernels: CUDA C++ for Hopper and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/decode.py``.  The kernel-injected
decode step runs each layer as four calls:

- :func:`fused_norm_qkv`  — norm → one concatenated QKV projection;
- :func:`flash_decode`    — single-token attention over the paged KV pool
  (serving) or over a contiguous [B, Hkv, Smax, Dh] cache (``generate()``),
  visiting only the keys up to each row's depth;
- :func:`fused_proj_norm` — attention out-projection → residual add → the
  MLP's norm;
- :func:`fused_mlp`       — (gated) MLP → residual add.

A CUDA tensor launches the kernel of ``deepspeed_tpu_torch/csrc/decode.cu``
(built by nvcc at first use, called through ctypes) or raises; a CPU tensor
runs the plain version, which copies the jnp reference of the JAX module op
for op (``_norm_qkv_ref``, ``_flash_decode_ref`` — over the gathered logical
view for the paged pool —, ``_proj_norm_ref``, ``_mlp_ref``).  ``fused_mlp``
honours its three biases independently, as ``_mlp_ref`` does (the Pallas
kernel gates them all on ``b_up``).  The wrappers check device, dtype, shape,
contiguity and alignment and raise: they never copy or cast an input.

In bf16 and fp16 ``fused_norm_qkv``, ``fused_proj_norm`` and ``fused_mlp``
run on the tensor cores (``norm_qkv_mma_kernel``, ``proj_norm_mma_kernel``,
``mlp_act_mma_kernel`` + ``mlp_down_mma_kernel``: ``mma.sync`` over the
weight tiles the TMA streams into a ring, one launch a pass of 8 rows, two
for the MLP; proj_norm launches cooperatively, its norm after a grid
barrier; the MLP's down launch as a programmatic dependent of its act
launch); fp32 keeps the FFMA kernels, in full fp32.
The wrappers keep their scratch and tickets a device and stream.

int8 weights (``wscale`` / ``wscales``: an int8 payload with per-output-
column fp32 scales, the layout of ``models/quant.py``) run the int8 bodies
of the three GEMV kernels, which dequantize in the kernel as ``_deq`` does;
they take bf16 activations only (the int8 engine serves in bf16).
norm_qkv's and proj_norm's are the tensor-core core's
(``norm_qkv_int8_mma_kernel``, ``proj_norm_int8_mma_kernel``: a cooperative
launch, as the 16-bit proj_norm's); the int8 MLP has kernels of its own on
the tensor cores (``mlp_act_int8_mma_kernel`` + ``mlp_down_int8_mma_kernel``:
``mma.sync`` over the dequantized codes, streamed by a ``cp.async`` ring).
Every wrapper takes the
lean host path of :mod:`.common` (the raw stream handle, the device index
to the C entry, prototypes bound once).  Each variant has a launch function
and a launch counter of its own: ``flash_decode_contig_cuda`` and the three
``*_int8_cuda``.

``flash_decode`` (both caches) is one kernel, ``flash_decode_kernel``: each
(slot, KV head) row's keys are cut into chunks of 16 to 128 keys and split
over several blocks (``fd_plan``: one wave of the blocks the card holds,
the grid sized from a bound on the depth, never read back), each block
bringing its chunks into shared memory by bulk copies (the TMA); the last
block of a row merges the splits' fp32 (m, l, acc) in split order, so a
repeat gives the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.kernels.build import (bind, check_launch,
                                                   load_library)
from deepspeed_tpu_torch.ops.kernels.common import (KERNEL_DTYPES,
                                                    alibi_slopes_on,
                                                    check_kernel_input,
                                                    raw_stream, use_kernel)

NEG_INF = -1e30
NORM_KINDS = {"rmsnorm": 0, "layernorm": 1}
ACTIVATIONS = {"silu": 0, "gelu": 1, "gelu_exact": 2, "relu": 3}
# kernel limits (csrc/decode.cu): batch rows staged per pass, shared memory
# a block may use, head dim and GQA group of the attention kernel
_BATCH_PASS = 8
_SMEM_LIMIT = 200 * 1024
_MAX_HEAD_DIM = 256
_MAX_REP = 8
# flash_decode's grid (csrc/decode.cu flash_decode_kernel): threads a
# block, bytes of K rows a chunk, waves of resident blocks to aim for,
# blocks a row, (slot, KV head) rows a launch (one ticket each:
# ds_ticket_count() - 1)
_FD_THREADS = 256
_FD_CHUNK_BYTES = 16384
_FD_FILL = 1.0
_FD_MAX_SPLITS = 256
_FD_MAX_ROWS = 4096


# ---------------------------------------------------------------------------
# plain versions: the jnp references, op for op
# ---------------------------------------------------------------------------

def _normalize(x32, scale, bias, kind: str, eps: float):
    """fp32 norm over the last dim; ``bias`` ignored for rmsnorm."""
    if kind == "rmsnorm":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return y * scale
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return y * scale + bias


def _act(name: str, x):
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "gelu_exact":
        return torch.nn.functional.gelu(x, approximate="none")
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unsupported activation {name}")


def _dot32(a, w):
    """``dot_general(a, w, preferred_element_type=f32)``: the operands'
    products and sums in fp32."""
    return a.float() @ w.float()


def _deq(w, ws, dtype):
    """int8 payload x per-output-column scale -> the compute dtype (the
    in-kernel form of ``QTensor.astype``)."""
    return (w.float() * ws.reshape(1, -1)).to(dtype)


def _norm_qkv_ref(x, scale, bias, wqkv, bqkv, *, kind, eps, wscale=None):
    h = _normalize(x.float(), scale.float(), bias.float(), kind,
                   eps).to(x.dtype)
    if wscale is not None:
        wqkv = _deq(wqkv, wscale, x.dtype)
    y = _dot32(h, wqkv)
    if bqkv is not None:
        y = y + bqkv.float()
    return y.to(x.dtype)


def _flash_decode_ref(q, kcache, vcache, pos, *, scale, alibi=False):
    """Masked dense attention over the whole cache: q [B, H, Dh], caches
    [B, Hkv, Smax, Dh], ``pos`` a scalar or [B] depths."""
    B, H, Dh = q.shape
    Hkv, Smax = kcache.shape[1], kcache.shape[2]
    rep = H // Hkv
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    qf = q.float().reshape(B, Hkv, rep, Dh)
    kf = kcache.float()
    vf = vcache.float()
    s = torch.einsum("bgrd,bgkd->bgrk", qf, kf) * scale
    key_pos = torch.arange(Smax, device=q.device)
    if alibi:
        from deepspeed_tpu_torch.models.layers import alibi_slopes

        rel = (key_pos[None, :] - pos[:, None]).float()
        s = s + (alibi_slopes(H, device=q.device).reshape(1, Hkv, rep, 1)
                 * rel[:, None, None, :])
    mask = key_pos[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bgkd->bgrd", p, vf)
    return o.reshape(B, H, Dh).to(q.dtype)


def _flash_decode_paged_ref(q, kcache, vcache, pos, page_table, *, scale,
                            layer, alibi):
    """The JAX XLA path of ``_flash_decode_paged``: gather each slot's
    logical view out of the pool, then the dense reference."""
    from deepspeed_tpu_torch.models.decoding import paged_logical_view

    kc = kcache if layer is None else kcache[layer]
    vc = vcache if layer is None else vcache[layer]
    return _flash_decode_ref(q, paged_logical_view(kc, page_table),
                             paged_logical_view(vc, page_table), pos,
                             scale=scale, alibi=alibi)


def _proj_norm_ref(ctx, resid, wo, bo, scale, bias, *, kind, eps, parallel,
                   wscale=None):
    if wscale is not None:
        wo = _deq(wo, wscale, ctx.dtype)
    o = _dot32(ctx, wo)
    if bo is not None:
        o = o + bo.float()
    r32 = resid.float() + o
    nsrc = resid.float() if parallel else r32
    h = _normalize(nsrc, scale.float(), bias.float(), kind, eps)
    return r32.to(ctx.dtype), h.to(ctx.dtype)


def _mlp_ref(h, r, w_up, w_gate, w_down, b_up, b_gate, b_down, *, act,
             wscales=None):
    if wscales is not None:
        su, sg, sd = wscales
        w_up = _deq(w_up, su, h.dtype)
        w_down = _deq(w_down, sd, h.dtype)
        if w_gate is not None:
            w_gate = _deq(w_gate, sg, h.dtype)
    up = _dot32(h, w_up)
    if b_up is not None:
        up = up + b_up.float()
    if w_gate is not None:
        g = _dot32(h, w_gate)
        if b_gate is not None:
            g = g + b_gate.float()
        a = _act(act, g) * up
    else:
        a = _act(act, up)
    y = _dot32(a.to(h.dtype), w_down)
    if b_down is not None:
        y = y + b_down.float()
    return (r.float() + y).to(h.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# the C entries (bound once through build.bind; each takes the raw stream
# and the device index)
_NORM_QKV_ARGS = [_P] * 8 + [_I] * 4 + [_F, _I, _P, _I]
_NORM_QKV_INT8_ARGS = [_P] * 9 + [_I] * 4 + [_F, _P, _I]
_MLP_ARGS = [_P] * 11 + [_I] * 5 + [_P, _I]
_PROJ_NORM_ARGS = [_P] * 10 + [_I] * 4 + [_F, _I, _I, _P, _I]
_PROJ_NORM_INT8_ARGS = [_P] * 11 + [_I] * 4 + [_F, _I, _P, _I]
_Q8_ARGS = [_P] * 14 + [_I] * 4 + [_P, _I]
_FD_PAGED_ARGS = [_P] * 9 + [_I] * 8 + [_F, _I, _P, _I]
_FD_CONTIG_ARGS = [_P] * 4 + [_L, _I] + [_P] * 4 + [_I] * 7 + [_F, _I, _P, _I]
# tickets of the kernels that merge across blocks (``ds_ticket_count`` of
# them: one a column tile, then proj_norm's grid barrier), zeroed once a
# device and stream, their counts left at zero by every kernel; scratch of
# the GEMVs (r32, the tiles' statistics and partials), kept a device and
# stream and grown to the largest call's; the bytes each (K, N, kernel,
# device) needs
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_WORK: Dict[Tuple[int, int], torch.Tensor] = {}
_G16_WORKSPACE: Dict[Tuple[int, int, int, int], int] = {}
_MLP_WORKSPACE: Dict[Tuple[int, int, int, bool, int, int], int] = {}
_Q8_WORKSPACE: Dict[Tuple[int, int, bool, int], int] = {}
_FD_SLOTS: Dict[Tuple[int, int, int, int, int], int] = {}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, t: Optional[torch.Tensor], like: torch.Tensor,
           shape: Tuple[int, ...], *, vector: bool = False) -> None:
    """``t`` (when given) is a contiguous tensor of ``like``'s device and
    dtype with ``shape``; ``vector`` adds the 16-byte alignment the kernels'
    vector loads need."""
    if t is None:
        return
    check_kernel_input(name, t, like.device, dtype=like.dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel's 16-byte loads need a 16-byte "
                         f"aligned tensor")


def _check_columns(op: str, n: int, x: torch.Tensor) -> None:
    vec = 16 // x.element_size()
    if n % vec:
        raise ValueError(f"{op}: {n} output columns are not a multiple of "
                         f"{vec} (16-byte vectors of {x.dtype})")


def _check_staged(op: str, rows: int, width: int, x: torch.Tensor) -> None:
    need = min(rows, _BATCH_PASS) * width * x.element_size()
    if need > _SMEM_LIMIT:
        raise ValueError(f"{op}: {need} bytes of staged activations exceed "
                         f"the kernel's {_SMEM_LIMIT}-byte shared memory "
                         f"budget")


def _check_int8(op: str, x: torch.Tensor, w: torch.Tensor,
                shape: Tuple[int, int], ws, name: str) -> None:
    """An int8 weight ``w`` of ``shape`` on x's device (8-byte vectors of 8
    codes: the kernel's loads), its fp32 scale ``ws`` of one value a
    column, beside bf16 activations ``x``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{op}: int8 weights take bfloat16 activations (the "
                        f"int8 engine serves in bf16), got {x.dtype}")
    if w.device != x.device or w.dtype != torch.int8 or tuple(w.shape) != shape \
            or not w.is_contiguous():
        raise ValueError(f"{op} {name}: expected a contiguous int8 {shape} "
                         f"tensor on {x.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if w.data_ptr() % 8 or shape[1] % 8:
        raise ValueError(f"{op} {name}: the kernel's 8-byte loads need an "
                         f"8-byte aligned weight and a multiple of 8 columns")
    if ws.device != x.device or ws.dtype != torch.float32 \
            or ws.numel() != shape[1] or not ws.is_contiguous():
        raise ValueError(f"{op} {name} scale: expected {shape[1]} contiguous "
                         f"float32 values on {x.device}, got {ws.dtype} "
                         f"{tuple(ws.shape)} on {ws.device}")


def _kind_code(kind: str) -> int:
    if kind not in NORM_KINDS:
        raise ValueError(f"unsupported norm kind {kind!r}")
    return NORM_KINDS[kind]


def _tickets(dev: int, stream: int) -> int:
    """The zeroed tickets of CUDA device ``dev``'s ``stream`` (launches on
    one stream reuse them in order)."""
    t = _TICKETS.get((dev, stream))
    if t is None:
        t = _TICKETS[(dev, stream)] = torch.zeros(
            bind("decode", "ds_ticket_count", [])(), dtype=torch.int32,
            device=f"cuda:{dev}")
    return t.data_ptr()


def _workspace(dev: int, stream: int, nbytes: int) -> int:
    """Scratch of at least ``nbytes`` on device ``dev`` for ``stream``."""
    t = _WORK.get((dev, stream))
    if t is None or t.numel() < nbytes:
        t = _WORK[(dev, stream)] = torch.empty(max(nbytes, 256),
                                               dtype=torch.uint8,
                                               device=f"cuda:{dev}")
    return t.data_ptr()


def _gemv_workspace(dev: int, stream: int, code: int, B: int, K: int,
                    N: int, kind: int) -> int:
    """The GEMVs' scratch: the tensor-core kernels' layout of
    ``ds_gemv16_workspace`` (kind 0 norm_qkv, 1 proj_norm in bf16 and fp16,
    2 the int8 norm_qkv, 3 the int8 proj_norm); for fp32 proj_norm's r32
    [B, N]."""
    if code == 0:
        return _workspace(dev, stream, B * N * 4)
    nbytes = _G16_WORKSPACE.get((K, N, kind, dev))
    if nbytes is None:
        nbytes = _G16_WORKSPACE[(K, N, kind, dev)] = bind(
            "decode", "ds_gemv16_workspace", [_I] * 4, _L)(K, N, kind, dev)
    return _workspace(dev, stream, nbytes)


def _mlp_workspace(dev: int, stream: int, code: int, B: int, D: int, F: int,
                   glu: bool) -> int:
    """fused_mlp's scratch (``ds_fused_mlp_workspace``): fp32's [F, B]
    activations, or the tensor-core launches' ``a`` and partials."""
    key = (B if code == 0 else 0, D, F, glu, code, dev)
    nbytes = _MLP_WORKSPACE.get(key)
    if nbytes is None:
        nbytes = _MLP_WORKSPACE[key] = bind(
            "decode", "ds_fused_mlp_workspace", [_I] * 6, _L)(
                B, D, F, int(glu), code, dev)
    return _workspace(dev, stream, nbytes)


def _ok(t: Optional[torch.Tensor], dev: int, dt: torch.dtype, shape) -> bool:
    """``t`` is absent, or a contiguous tensor of ``dt`` and ``shape`` on
    CUDA device ``dev``: the lean test, one attribute pass."""
    return t is None or (t.get_device() == dev and t.dtype is dt
                         and t.shape == shape and t.is_contiguous())


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _check_mma(op: str, k: int, x: torch.Tensor, *ts) -> None:
    """What the bf16 and fp16 GEMVs add: 16-byte copies of the activations
    (and of norm_qkv's scale and bias), so a contraction of whole 16-byte
    vectors and 16-byte aligned tensors."""
    if x.element_size() != 2:
        return
    if k % 8:
        raise ValueError(f"{op}: a contraction of {k} is not a multiple of "
                         f"8 (the kernel's 16-byte copies of {x.dtype})")
    if not _aligned(x, *ts):
        raise ValueError(f"{op}: the kernel's 16-byte copies need 16-byte "
                         f"aligned activations")


def _refuse_norm_qkv(x, scale, bias, wqkv, bqkv, kind) -> None:
    """Raise what the kernel refuses: the full checks, run only once the
    lean test has failed."""
    check_kernel_input("fused_norm_qkv x", x, x.device)
    if x.dim() != 2 or wqkv.dim() != 2:
        raise ValueError(f"fused_norm_qkv: x [B, D] and wqkv [D, N], got "
                         f"{tuple(x.shape)} and {tuple(wqkv.shape)}")
    B, D = x.shape
    N = wqkv.shape[1]
    _check("fused_norm_qkv scale", scale, x, (D,))
    _check("fused_norm_qkv bias", bias, x, (D,))
    _check("fused_norm_qkv wqkv", wqkv, x, (D, N), vector=True)
    _check("fused_norm_qkv bqkv", bqkv, x, (N,))
    _check_columns("fused_norm_qkv", N, x)
    if x.element_size() == 4:
        _check_staged("fused_norm_qkv", B, D, x)
    _check_mma("fused_norm_qkv", D, x, scale, bias)
    _kind_code(kind)
    raise ValueError("fused_norm_qkv: inputs the kernel does not take")


def _refuse_proj_norm(ctx, resid, wo, bo, scale, bias, kind) -> None:
    """Raise what the kernel refuses: the full checks, run only once the
    lean test has failed."""
    check_kernel_input("fused_proj_norm ctx", ctx, ctx.device)
    if ctx.dim() != 2 or wo.dim() != 2:
        raise ValueError(f"fused_proj_norm: ctx [B, M] and wo [M, D], got "
                         f"{tuple(ctx.shape)} and {tuple(wo.shape)}")
    B, M = ctx.shape
    D = wo.shape[1]
    _check("fused_proj_norm resid", resid, ctx, (B, D))
    _check("fused_proj_norm wo", wo, ctx, (M, D), vector=True)
    _check("fused_proj_norm bo", bo, ctx, (D,))
    _check("fused_proj_norm scale", scale, ctx, (D,))
    _check("fused_proj_norm bias", bias, ctx, (D,))
    _check_columns("fused_proj_norm", D, ctx)
    if ctx.element_size() == 4:
        _check_staged("fused_proj_norm", B, M, ctx)
    _check_mma("fused_proj_norm", M, ctx)
    _kind_code(kind)
    raise ValueError("fused_proj_norm: inputs the kernel does not take")


def fused_norm_qkv_cuda(x, scale, bias, wqkv, bqkv=None, *, kind, eps):
    """Launch ``norm_qkv_mma_kernel`` (bf16, fp16: the tensor cores, one
    launch a pass of 8 rows) or ``norm_qkv_kernel`` (fp32): x [B, D] → [B, N]
    in x's dtype, on the lean host path of :func:`.layer_norm.rms_norm_cuda`
    (the raw stream, the device index to the C entry, the prototype bound
    once, no ``torch.cuda.device`` and no ``torch.cuda.Stream``)."""
    dev, dt = x.get_device(), x.dtype
    code = KERNEL_DTYPES.get(dt)
    shp = x.shape
    wsh = wqkv.shape
    if (code is None or dev < 0 or len(shp) != 2 or len(wsh) != 2
            or not x.is_contiguous() or kind not in NORM_KINDS):
        _refuse_norm_qkv(x, scale, bias, wqkv, bqkv, kind)
    B, D = shp
    N = wsh[1]
    if not (scale is not None and _ok(scale, dev, dt, (D,)) and _ok(bias, dev, dt, (D,))
            and _ok(wqkv, dev, dt, (D, N)) and _ok(bqkv, dev, dt, (N,))
            and N % (16 // x.element_size()) == 0 and wqkv.data_ptr() % 16 == 0
            and (min(B, _BATCH_PASS) * D * 4 <= _SMEM_LIMIT if code == 0 else
                 D % 8 == 0 and _aligned(x, scale, bias))):
        _refuse_norm_qkv(x, scale, bias, wqkv, bqkv, kind)
    out = x.new_empty((B, N))
    stream = raw_stream(dev)
    err = bind("decode", "ds_fused_norm_qkv", _NORM_QKV_ARGS)(
        x.data_ptr(), scale.data_ptr(), _ptr(bias), wqkv.data_ptr(),
        _ptr(bqkv), out.data_ptr(),
        _gemv_workspace(dev, stream, code, B, D, N, 0), _tickets(dev, stream),
        B, D, N, NORM_KINDS[kind], eps, code, stream, dev)
    if err:
        check_launch(load_library("decode"), "fused_norm_qkv", err)
    fused_norm_qkv.launches += 1
    return out


def fd_chunk(Dh: int, itemsize: int) -> int:
    """Keys a flash_decode chunk holds: the largest power of two from 16 to
    128 whose K rows fit in ``_FD_CHUNK_BYTES`` (64 keys at Dh 128 in bf16,
    128 at Dh 64, 32 at Dh 128 in fp32)."""
    c = 128
    while c > 16 and c * Dh * itemsize > _FD_CHUNK_BYTES:
        c //= 2
    return c


def fd_plan(B: int, Hkv: int, rep: int, Dh: int, itemsize: int, keys: int,
            slots: int) -> Tuple[int, int, int]:
    """The grid of one flash_decode launch: (chunk, splits, scratch bytes).
    ``keys`` bounds every row's depth (the exact depth for one scalar
    position, else Smax or maxp * page: nothing is read back from the
    device); ``slots`` is the blocks the card holds at once (its SMs times
    the kernel's blocks an SM).  Each (slot, KV head) row gets ``splits``
    blocks: as many as fill ``_FD_FILL`` waves of the slots, no more than
    the chunks of ``keys`` nor ``_FD_MAX_SPLITS``.  The scratch holds each
    split's fp32 (acc, m, l) for the rows of one pass (``_FD_MAX_ROWS``
    rows, a ticket each)."""
    chunk = fd_chunk(Dh, itemsize)
    rows = min(B, max(1, _FD_MAX_ROWS // Hkv)) * Hkv
    chunks = max(1, -(-keys // chunk))
    splits = max(1, min(chunks, int(slots * _FD_FILL) // rows, _FD_MAX_SPLITS))
    nbytes = rows * splits * rep * (Dh + 2) * 4 if splits > 1 else 0
    return chunk, splits, nbytes


def fd_split_keys(n_tok: int, chunk: int, splits: int):
    """The [start, end) keys each live split of one row takes, as the
    kernel cuts them: whole chunks, ceil(chunks / splits) a split, so the
    splits past ceil(chunks / per) hold none and return at once."""
    n_chunks = -(-max(n_tok, 0) // chunk)
    per = -(-n_chunks // splits)
    live = -(-n_chunks // per) if per else 0
    return [(s * per * chunk, min(n_tok, (s + 1) * per * chunk))
            for s in range(live)]


def fd_chunk_pages(c: int, chunk: int, page: int, maxp: int) -> Tuple[int, int]:
    """The [first, last) page-table entries chunk ``c`` reads (the slot the
    kernel stages in shared memory: at most ``chunk`` entries)."""
    return c * chunk // page, min(maxp, (c * chunk + chunk - 1) // page + 1)


def fd_smem_bytes(Dh: int, rep: int, chunk: int, itemsize: int) -> int:
    """Shared memory of one flash_decode block (``fd_smem_bytes`` of
    csrc/decode.cu): the K and V chunks, q, scores, probabilities, the P.V
    key groups' partials, (m, l, alpha) and two slots of page-table
    entries.  Independent of Smax and of maxp."""
    R = 1 if rep <= 1 else 2 if rep <= 2 else 4 if rep <= 4 else 8
    groups = _FD_THREADS // (Dh // 2)
    return (2 * chunk * Dh * itemsize
            + 4 * (R * Dh + 2 * R * chunk + groups * R * Dh + 4 * R)
            + 2 * chunk * 8)


def _fd_slots(dev: int, code: int, Dh: int, rep: int, chunk: int) -> int:
    """Blocks of flash_decode_kernel CUDA device ``dev`` holds at once (its
    SMs times the occupancy the CUDA runtime reports), read once a shape."""
    key = (dev, code, Dh, rep, chunk)
    n = _FD_SLOTS.get(key)
    if n is None:
        per_sm = bind("decode", "ds_flash_decode_resident", [_I] * 5)(
            Dh, rep, chunk, code, dev)
        if per_sm <= 0:
            raise RuntimeError(f"flash_decode: no block of Dh {Dh}, {rep} "
                               f"heads a KV head fits an SM")
        n = _FD_SLOTS[key] = per_sm * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _fd_common_ok(q, kcache, vcache, dev, dt, ks, layer) -> bool:
    """The lean test of what both caches share: q [B, H, Dh] and the two
    caches of one shape, dtype and device, 16-byte aligned (the kernel's
    bulk copies); Dh a multiple of 8 up to 256; a GQA group of up to 8; the
    layer in range."""
    B, H, Dh = q.shape
    Hkv = ks[-3]
    return (_ok(kcache, dev, dt, ks) and _ok(vcache, dev, dt, ks)
            and _aligned(kcache, vcache)
            and ks[-1] == Dh and Dh % 8 == 0 and 0 < Dh <= _MAX_HEAD_DIM
            and Hkv > 0 and H % Hkv == 0 and H // Hkv <= _MAX_REP
            and (layer is None or 0 <= layer < ks[0]))


def _refuse_fd_common(q, kcache, vcache, layer, paged: bool) -> None:
    """Raise what both caches' kernels refuse: the full checks, run only
    once the lean test has failed."""
    check_kernel_input("flash_decode q", q, q.device)
    if q.dim() != 3:
        raise ValueError(f"flash_decode: q must be [B, H, Dh], got "
                         f"{tuple(q.shape)}")
    B, H, Dh = q.shape
    want = 4 if layer is None else 5
    if paged and kcache.dim() != want:
        raise ValueError(f"flash_decode: pool must be {want}-d "
                         f"({'[P, Hkv, page, Dh]' if layer is None else '[L, P, Hkv, page, Dh]'}), "
                         f"got {tuple(kcache.shape)}")
    if not paged and (kcache.dim() != want or kcache.shape[-4] != B):
        raise ValueError(f"flash_decode: cache must be "
                         f"{'[B, Hkv, Smax, Dh]' if layer is None else '[L, B, Hkv, Smax, Dh]'}"
                         f" with B = {B}, got {tuple(kcache.shape)}")
    _check("flash_decode kcache", kcache, q, tuple(kcache.shape))
    _check("flash_decode vcache", vcache, q, tuple(kcache.shape))
    Hkv = kcache.shape[-3]
    if kcache.shape[-1] != Dh:
        raise ValueError(f"flash_decode: {'pool' if paged else 'cache'} head "
                         f"dim {kcache.shape[-1]} != q head dim {Dh}")
    if Dh % 8 or Dh > _MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head dim {Dh} must be a multiple "
                         f"of 8 up to {_MAX_HEAD_DIM}")
    if H % Hkv or H // Hkv > _MAX_REP:
        raise ValueError(f"flash_decode: {H} query heads over {Hkv} KV heads "
                         f"(the kernel takes GQA groups of up to {_MAX_REP})")
    if layer is not None and not 0 <= layer < kcache.shape[0]:
        raise ValueError(f"flash_decode: layer {layer} out of range "
                         f"[0, {kcache.shape[0]})")
    if not _aligned(kcache, vcache):
        raise ValueError("flash_decode: the kernel's bulk copies need 16-byte "
                         "aligned caches")


def _refuse_flash_decode_paged(q, kcache, vcache, pos, page_table,
                               layer) -> None:
    _refuse_fd_common(q, kcache, vcache, layer, paged=True)
    B = q.shape[0]
    for name, t, shape in (("pos", pos, (B,)),
                           ("page_table", page_table,
                            (B, page_table.shape[-1]))):
        if t.device != q.device or t.dtype != torch.int64:
            raise TypeError(f"flash_decode {name}: expected int64 on "
                            f"{q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"flash_decode {name}: expected a contiguous "
                             f"{shape} tensor, got {tuple(t.shape)}")
    raise ValueError("flash_decode: inputs the kernel does not take")


def _refuse_flash_decode_contig(q, kcache, vcache, pos, layer) -> None:
    _refuse_fd_common(q, kcache, vcache, layer, paged=False)
    if isinstance(pos, torch.Tensor):
        if pos.device != q.device or pos.dtype != torch.int64:
            raise TypeError(f"flash_decode pos: expected int64 on {q.device}, "
                            f"got {pos.dtype} on {pos.device}")
        if pos.numel() not in (1, q.shape[0]) or not pos.is_contiguous():
            raise ValueError(f"flash_decode pos: expected a contiguous tensor "
                             f"of 1 or {q.shape[0]} depths, got "
                             f"{tuple(pos.shape)}")
    raise ValueError("flash_decode: inputs the kernel does not take")


def flash_decode_paged_cuda(q, kcache, vcache, pos, page_table, *, scale,
                            layer=None, alibi=False):
    """Launch ``flash_decode_kernel``: q [B, H, Dh] over the pool
    [P, Hkv, page, Dh] (or the stacked [L, P, Hkv, page, Dh] at ``layer``,
    read in place); ``pos`` [B] and ``page_table`` [B, maxp] int64.  Each
    row's keys split over ``fd_plan``'s blocks (the grid sized from maxp *
    page: no depth is read back), merged in split order by the last block
    of the row.  On the lean host path of :func:`fused_norm_qkv_cuda`."""
    dev, dt = q.get_device(), q.dtype
    code = KERNEL_DTYPES.get(dt)
    ks = kcache.shape
    if not (code is not None and dev >= 0 and q.dim() == 3
            and len(ks) == (4 if layer is None else 5) and page_table.dim() == 2
            and q.is_contiguous()):
        _refuse_flash_decode_paged(q, kcache, vcache, pos, page_table, layer)
    B, H, Dh = q.shape
    maxp = page_table.shape[1]
    if not (_fd_common_ok(q, kcache, vcache, dev, dt, ks, layer)
            and _ok(pos, dev, torch.int64, (B,))
            and _ok(page_table, dev, torch.int64, (B, maxp))):
        _refuse_flash_decode_paged(q, kcache, vcache, pos, page_table, layer)
    Hkv, page = ks[-3], ks[-2]
    esz, rep = q.element_size(), H // Hkv
    chunk, splits, nbytes = fd_plan(
        B, Hkv, rep, Dh, esz, maxp * page,
        _fd_slots(dev, code, Dh, rep, fd_chunk(Dh, esz)))
    off = 0 if layer is None else layer * kcache.stride(0) * esz
    slopes = alibi_slopes_on(H, q.device) if alibi else None
    out = torch.empty_like(q)
    stream = raw_stream(dev)
    err = bind("decode", "ds_flash_decode_paged", _FD_PAGED_ARGS)(
        q.data_ptr(), kcache.data_ptr() + off, vcache.data_ptr() + off,
        pos.data_ptr(), page_table.data_ptr(), _ptr(slopes), out.data_ptr(),
        _workspace(dev, stream, nbytes), _tickets(dev, stream), B, H, Hkv, Dh,
        page, maxp, chunk, splits, float(scale), code, stream, dev)
    if err:
        check_launch(load_library("decode"), "flash_decode", err)
    flash_decode.launches += 1
    return out


def flash_decode_contig_cuda(q, kcache, vcache, pos, *, scale, layer=None,
                             alibi=False):
    """Launch ``flash_decode_kernel`` over a contiguous cache: q [B, H, Dh]
    against [B, Hkv, Smax, Dh] (or the stacked [L, B, Hkv, Smax, Dh] at
    ``layer``, read in place), the layer's slice addressed as a pool whose
    page is Smax and whose page of row b is b.  ``pos`` is an int (one
    depth for the batch, passed by value: the grid fits that depth) or an
    int64 tensor of 1 or B depths (the grid fits Smax).  On the lean host
    path of :func:`fused_norm_qkv_cuda`."""
    dev, dt = q.get_device(), q.dtype
    code = KERNEL_DTYPES.get(dt)
    ks = kcache.shape
    if not (code is not None and dev >= 0 and q.dim() == 3
            and len(ks) == (4 if layer is None else 5) and q.is_contiguous()
            and ks[-4] == q.shape[0]):
        _refuse_flash_decode_contig(q, kcache, vcache, pos, layer)
    B, H, Dh = q.shape
    if not _fd_common_ok(q, kcache, vcache, dev, dt, ks, layer):
        _refuse_flash_decode_contig(q, kcache, vcache, pos, layer)
    Hkv, Smax = ks[-3], ks[-2]
    if isinstance(pos, torch.Tensor):
        n = pos.numel()
        if not (pos.get_device() == dev and pos.dtype is torch.int64
                and n in (1, B) and pos.is_contiguous()):
            _refuse_flash_decode_contig(q, kcache, vcache, pos, layer)
        pos_ptr, pos0, stride, keys = pos.data_ptr(), 0, int(n == B), Smax
    else:
        pos0 = int(pos)
        pos_ptr, stride, keys = None, 0, min(max(pos0 + 1, 1), Smax)
    esz, rep = q.element_size(), H // Hkv
    chunk, splits, nbytes = fd_plan(
        B, Hkv, rep, Dh, esz, keys,
        _fd_slots(dev, code, Dh, rep, fd_chunk(Dh, esz)))
    off = 0 if layer is None else layer * kcache.stride(0) * esz
    slopes = alibi_slopes_on(H, q.device) if alibi else None
    out = torch.empty_like(q)
    stream = raw_stream(dev)
    err = bind("decode", "ds_flash_decode_contig", _FD_CONTIG_ARGS)(
        q.data_ptr(), kcache.data_ptr() + off, vcache.data_ptr() + off,
        pos_ptr, pos0, stride, _ptr(slopes), out.data_ptr(),
        _workspace(dev, stream, nbytes), _tickets(dev, stream), B, H, Hkv, Dh,
        Smax, chunk, splits, float(scale), code, stream, dev)
    if err:
        check_launch(load_library("decode"), "flash_decode (contiguous)", err)
    flash_decode_contig_cuda.launches += 1
    return out


def fused_proj_norm_cuda(ctx, resid, wo, bo, scale, bias, *, kind, eps,
                         parallel):
    """Launch ``proj_norm_mma_kernel`` (bf16, fp16: the tensor cores, one
    launch a pass of 8 rows) or ``proj_norm_kernel`` (fp32): returns (r, h),
    both [B, D], on the lean host path of :func:`fused_norm_qkv_cuda`."""
    dev, dt = ctx.get_device(), ctx.dtype
    code = KERNEL_DTYPES.get(dt)
    shp = ctx.shape
    wsh = wo.shape
    if (code is None or dev < 0 or len(shp) != 2 or len(wsh) != 2
            or not ctx.is_contiguous() or kind not in NORM_KINDS):
        _refuse_proj_norm(ctx, resid, wo, bo, scale, bias, kind)
    B, M = shp
    D = wsh[1]
    if not (_ok(resid, dev, dt, (B, D)) and _ok(wo, dev, dt, (M, D))
            and _ok(bo, dev, dt, (D,)) and scale is not None
            and _ok(scale, dev, dt, (D,)) and _ok(bias, dev, dt, (D,))
            and D % (16 // ctx.element_size()) == 0 and wo.data_ptr() % 16 == 0
            and (min(B, _BATCH_PASS) * M * 4 <= _SMEM_LIMIT if code == 0 else
                 M % 8 == 0 and ctx.data_ptr() % 16 == 0)):
        _refuse_proj_norm(ctx, resid, wo, bo, scale, bias, kind)
    r = ctx.new_empty((B, D))
    h = ctx.new_empty((B, D))
    stream = raw_stream(dev)
    err = bind("decode", "ds_fused_proj_norm", _PROJ_NORM_ARGS)(
        ctx.data_ptr(), resid.data_ptr(), wo.data_ptr(), _ptr(bo),
        scale.data_ptr(), _ptr(bias), r.data_ptr(), h.data_ptr(),
        _gemv_workspace(dev, stream, code, B, M, D, 1), _tickets(dev, stream),
        B, M, D, NORM_KINDS[kind], eps, int(bool(parallel)), code, stream, dev)
    if err:
        check_launch(load_library("decode"), "fused_proj_norm", err)
    fused_proj_norm.launches += 1
    return r, h


def _refuse_mlp(h, r, w_up, w_down, w_gate, b_up, b_gate, b_down,
                act) -> None:
    """Raise what the kernels refuse: the full checks, run only once the
    lean test has failed."""
    check_kernel_input("fused_mlp h", h, h.device)
    if h.dim() != 2 or w_up.dim() != 2:
        raise ValueError(f"fused_mlp: h [B, D] and w_up [D, F], got "
                         f"{tuple(h.shape)} and {tuple(w_up.shape)}")
    B, D = h.shape
    F = w_up.shape[1]
    _check("fused_mlp r", r, h, (B, D))
    _check("fused_mlp w_up", w_up, h, (D, F), vector=True)
    _check("fused_mlp w_gate", w_gate, h, (D, F), vector=True)
    _check("fused_mlp w_down", w_down, h, (F, D), vector=True)
    _check("fused_mlp b_up", b_up, h, (F,))
    _check("fused_mlp b_gate", b_gate, h, (F,))
    _check("fused_mlp b_down", b_down, h, (D,))
    _check_columns("fused_mlp", F, h)
    _check_columns("fused_mlp", D, h)
    if h.element_size() == 4:
        _check_staged("fused_mlp", B, D, h)
    elif h.data_ptr() % 16:
        raise ValueError("fused_mlp h: the kernel's 16-byte copies need a "
                         "16-byte aligned tensor")
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act}")
    raise ValueError("fused_mlp: inputs the kernel does not take")


def fused_mlp_cuda(h, r, w_up, w_down, w_gate=None, b_up=None, b_gate=None,
                   b_down=None, *, act):
    """Launch ``mlp_act_mma_kernel`` then ``mlp_down_mma_kernel`` (bf16,
    fp16: the tensor cores, a pair a pass of 8 rows, the down launch a
    programmatic dependent of the act launch) or
    ``mlp_act_kernel`` then ``mlp_down_kernel`` (fp32): r + mlp(h), on the
    lean host path of :func:`fused_norm_qkv_cuda` (no ``torch.cuda.device``,
    no ``torch.cuda.Stream``, the activations between the launches in the
    scratch kept a device and stream)."""
    dev, dt = h.get_device(), h.dtype
    code = KERNEL_DTYPES.get(dt)
    shp = h.shape
    wsh = w_up.shape
    if (code is None or dev < 0 or len(shp) != 2 or len(wsh) != 2
            or not h.is_contiguous() or act not in ACTIVATIONS):
        _refuse_mlp(h, r, w_up, w_down, w_gate, b_up, b_gate, b_down, act)
    B, D = shp
    F = wsh[1]
    vec = 16 // h.element_size()
    if not (r is not None and _ok(r, dev, dt, (B, D))
            and _ok(w_up, dev, dt, (D, F)) and _ok(w_gate, dev, dt, (D, F))
            and w_down is not None and _ok(w_down, dev, dt, (F, D))
            and _ok(b_up, dev, dt, (F,)) and _ok(b_gate, dev, dt, (F,))
            and _ok(b_down, dev, dt, (D,)) and D % vec == 0 and F % vec == 0
            and _aligned(w_up, w_gate, w_down)
            and (min(B, _BATCH_PASS) * D * 4 <= _SMEM_LIMIT if code == 0 else
                 h.data_ptr() % 16 == 0)):
        _refuse_mlp(h, r, w_up, w_down, w_gate, b_up, b_gate, b_down, act)
    out = torch.empty_like(h)
    stream = raw_stream(dev)
    err = bind("decode", "ds_fused_mlp", _MLP_ARGS)(
        h.data_ptr(), r.data_ptr(), w_up.data_ptr(), _ptr(w_gate),
        w_down.data_ptr(), _ptr(b_up), _ptr(b_gate), _ptr(b_down),
        _mlp_workspace(dev, stream, code, B, D, F, w_gate is not None),
        _tickets(dev, stream), out.data_ptr(), B, D, F, ACTIVATIONS[act],
        code, stream, dev)
    if err:
        check_launch(load_library("decode"), "fused_mlp", err)
    fused_mlp.launches += 1
    return out


def fused_norm_qkv_int8_cuda(x, scale, bias, wqkv, wscale, bqkv=None, *,
                             kind, eps):
    """Launch ``norm_qkv_int8_mma_kernel`` (the tensor cores, one launch a
    pass of 8 rows): bf16 x [B, D], int8 wqkv [D, N] with its fp32 scale (N
    values) -> [B, N] bf16, on the lean host path of
    :func:`fused_norm_qkv_cuda`."""
    check_kernel_input("fused_norm_qkv x", x, x.device)
    if x.dim() != 2 or wqkv.dim() != 2:
        raise ValueError(f"fused_norm_qkv: x [B, D] and wqkv [D, N], got "
                         f"{tuple(x.shape)} and {tuple(wqkv.shape)}")
    B, D = x.shape
    N = wqkv.shape[1]
    _check_int8("fused_norm_qkv", x, wqkv, (D, N), wscale, "wqkv")
    _check("fused_norm_qkv scale", scale, x, (D,))
    _check("fused_norm_qkv bias", bias, x, (D,))
    _check("fused_norm_qkv bqkv", bqkv, x, (N,))
    _check_mma("fused_norm_qkv", D, x, scale, bias)
    code_kind = _kind_code(kind)
    out = x.new_empty((B, N))
    dev = x.get_device()
    stream = raw_stream(dev)
    err = bind("decode", "ds_fused_norm_qkv_int8", _NORM_QKV_INT8_ARGS)(
        x.data_ptr(), scale.data_ptr(), _ptr(bias), wqkv.data_ptr(),
        wscale.data_ptr(), _ptr(bqkv), out.data_ptr(),
        _gemv_workspace(dev, stream, 1, B, D, N, 2), _tickets(dev, stream),
        B, D, N, code_kind, float(eps), stream, dev)
    if err:
        check_launch(load_library("decode"), "fused_norm_qkv (int8)", err)
    fused_norm_qkv_int8_cuda.launches += 1
    return out


def fused_proj_norm_int8_cuda(ctx, resid, wo, wscale, bo, scale, bias, *,
                              kind, eps, parallel):
    """Launch ``proj_norm_int8_mma_kernel`` (the tensor cores, one
    cooperative launch a pass of 8 rows, the norm after a grid barrier):
    bf16 ctx [B, M], int8 wo [M, D] with its fp32 scale (D values); returns
    (r, h), on the lean host path of :func:`fused_norm_qkv_cuda`."""
    check_kernel_input("fused_proj_norm ctx", ctx, ctx.device)
    if ctx.dim() != 2 or wo.dim() != 2:
        raise ValueError(f"fused_proj_norm: ctx [B, M] and wo [M, D], got "
                         f"{tuple(ctx.shape)} and {tuple(wo.shape)}")
    B, M = ctx.shape
    D = wo.shape[1]
    _check_int8("fused_proj_norm", ctx, wo, (M, D), wscale, "wo")
    _check("fused_proj_norm resid", resid, ctx, (B, D))
    _check("fused_proj_norm bo", bo, ctx, (D,))
    _check("fused_proj_norm scale", scale, ctx, (D,))
    _check("fused_proj_norm bias", bias, ctx, (D,))
    _check_mma("fused_proj_norm", M, ctx)
    code_kind = _kind_code(kind)
    r = ctx.new_empty((B, D))
    h = ctx.new_empty((B, D))
    dev = ctx.get_device()
    stream = raw_stream(dev)
    err = bind("decode", "ds_fused_proj_norm_int8", _PROJ_NORM_INT8_ARGS)(
        ctx.data_ptr(), resid.data_ptr(), wo.data_ptr(), wscale.data_ptr(),
        _ptr(bo), scale.data_ptr(), _ptr(bias), r.data_ptr(), h.data_ptr(),
        _gemv_workspace(dev, stream, 1, B, M, D, 3), _tickets(dev, stream),
        B, M, D, code_kind, float(eps), int(bool(parallel)), stream, dev)
    if err:
        check_launch(load_library("decode"), "fused_proj_norm (int8)", err)
    fused_proj_norm_int8_cuda.launches += 1
    return r, h


def fused_mlp_int8_cuda(h, r, w_up, w_down, w_gate, wscales, b_up=None,
                        b_gate=None, b_down=None, *, act):
    """Launch ``mlp_act_int8_mma_kernel`` then ``mlp_down_int8_mma_kernel``
    (a pair a pass of 8 rows): r + mlp(h) over int8 weights with
    ``wscales`` = (su, sg, sd), on the lean host path of
    :func:`.layer_norm.rms_norm_cuda`."""
    check_kernel_input("fused_mlp h", h, h.device)
    if h.dim() != 2 or w_up.dim() != 2:
        raise ValueError(f"fused_mlp: h [B, D] and w_up [D, F], got "
                         f"{tuple(h.shape)} and {tuple(w_up.shape)}")
    B, D = h.shape
    F = w_up.shape[1]
    su, sg, sd = wscales
    _check_int8("fused_mlp", h, w_up, (D, F), su, "w_up")
    if w_gate is not None:
        _check_int8("fused_mlp", h, w_gate, (D, F), sg, "w_gate")
    _check_int8("fused_mlp", h, w_down, (F, D), sd, "w_down")
    _check("fused_mlp r", r, h, (B, D))
    _check("fused_mlp b_up", b_up, h, (F,))
    _check("fused_mlp b_gate", b_gate, h, (F,))
    _check("fused_mlp b_down", b_down, h, (D,))
    _check_columns("fused_mlp", D, h)
    if h.data_ptr() % 16:
        raise ValueError("fused_mlp h: the kernel's 16-byte copies need a "
                         "16-byte aligned tensor")
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act}")
    dev = h.get_device()
    glu = w_gate is not None
    nbytes = _Q8_WORKSPACE.get((D, F, glu, dev))
    if nbytes is None:
        nbytes = _Q8_WORKSPACE[(D, F, glu, dev)] = bind(
            "decode", "ds_fused_mlp_int8_workspace", [_I] * 4, _L)(D, F, glu,
                                                                  dev)
    stream = raw_stream(dev)
    work = torch.empty(nbytes, dtype=torch.uint8, device=h.device)
    out = torch.empty_like(h)
    code = bind("decode", "ds_fused_mlp_int8", _Q8_ARGS)(
        h.data_ptr(), r.data_ptr(), w_up.data_ptr(), _ptr(w_gate),
        w_down.data_ptr(), su.data_ptr(), sg.data_ptr() if glu else None,
        sd.data_ptr(), _ptr(b_up), _ptr(b_gate), _ptr(b_down),
        work.data_ptr(), _tickets(dev, stream), out.data_ptr(), B, D, F,
        ACTIVATIONS[act], stream, dev)
    if code:
        check_launch(load_library("decode"), "fused_mlp (int8)", code)
    fused_mlp_int8_cuda.launches += 1
    return out


# ---------------------------------------------------------------------------
# public wrappers (the JAX signatures, without ``impl``)
# ---------------------------------------------------------------------------

def fused_norm_qkv(x, scale, bias, wqkv, bqkv=None, *,
                   kind: str = "layernorm", eps: float = 1e-5, wscale=None):
    """x [B, D]; wqkv [D, N]; returns norm(x) @ wqkv (+ bqkv) as [B, N] in
    x's dtype, the normalised rows rounded to x's dtype before the product
    and the product summed in fp32.  ``wscale`` (one fp32 scale a column)
    marks ``wqkv`` as int8 codes, dequantized in the kernel."""
    if wscale is not None and x.dtype != torch.bfloat16:
        raise TypeError(f"fused_norm_qkv: int8 weights take bfloat16 "
                        f"activations, got {x.dtype}")
    if use_kernel(x):
        if wscale is not None:
            return fused_norm_qkv_int8_cuda(x, scale, bias, wqkv, wscale, bqkv,
                                            kind=kind, eps=eps)
        return fused_norm_qkv_cuda(x, scale, bias, wqkv, bqkv, kind=kind,
                                   eps=eps)
    if bias is None:
        bias = torch.zeros_like(scale)
    return _norm_qkv_ref(x, scale, bias, wqkv, bqkv, kind=kind, eps=eps,
                         wscale=wscale)


def flash_decode(q, kcache, vcache, pos, *, sm_scale: Optional[float] = None,
                 block: int = 256, layer: Optional[int] = None,
                 alibi: bool = False, page_table=None):
    """Single-token attention.  q [B, H, Dh]; with ``page_table`` [B, maxp]
    the caches are the paged pool [P, Hkv, page, Dh] (or stacked
    [L, P, Hkv, page, Dh] read at ``layer``) and ``pos`` [B] holds each
    slot's depth: keys 0..pos[b] are attended, pages past pos[b] // page are
    neither read nor computed.  Without a page table the caches are
    contiguous, [B, Hkv, Smax, Dh] (or stacked [L, B, Hkv, Smax, Dh] read at
    ``layer``), and ``pos`` is an int shared by the batch or an int64 [B]
    (or [1]) tensor of per-row depths; keys past each row's depth are
    neither read nor computed, at any Smax.  ``block`` is the Pallas
    kernel's cache block; the CUDA kernel has no use for it."""
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if page_table is None:
        if use_kernel(q):
            return flash_decode_contig_cuda(q, kcache, vcache, pos,
                                            scale=scale, layer=layer,
                                            alibi=alibi)
        kc = kcache if layer is None else kcache[layer]
        vc = vcache if layer is None else vcache[layer]
        return _flash_decode_ref(q, kc, vc, pos, scale=scale, alibi=alibi)
    if use_kernel(q):
        return flash_decode_paged_cuda(q, kcache, vcache, pos, page_table,
                                       scale=scale, layer=layer, alibi=alibi)
    return _flash_decode_paged_ref(q, kcache, vcache, pos, page_table,
                                   scale=scale, layer=layer, alibi=alibi)


def fused_proj_norm(ctx, resid, wo, bo=None, scale=None, bias=None, *,
                    kind: str = "layernorm", eps: float = 1e-5,
                    parallel: bool = False, wscale=None):
    """ctx [B, M]; wo [M, D]; resid [B, D].  Returns (r, h): r = resid +
    ctx @ wo (+ bo), and h the norm of r's fp32 sum (of ``resid`` with
    ``parallel=True``, the gpt-neox parallel residual).  ``wscale`` marks
    ``wo`` as int8 codes, dequantized in the kernel."""
    if wscale is not None and ctx.dtype != torch.bfloat16:
        raise TypeError(f"fused_proj_norm: int8 weights take bfloat16 "
                        f"activations, got {ctx.dtype}")
    if use_kernel(ctx):
        if wscale is not None:
            return fused_proj_norm_int8_cuda(ctx, resid, wo, wscale, bo,
                                             scale, bias, kind=kind, eps=eps,
                                             parallel=parallel)
        return fused_proj_norm_cuda(ctx, resid, wo, bo, scale, bias,
                                    kind=kind, eps=eps, parallel=parallel)
    if bias is None:
        bias = torch.zeros_like(scale)
    return _proj_norm_ref(ctx, resid, wo, bo, scale, bias, kind=kind,
                          eps=eps, parallel=parallel, wscale=wscale)


def fused_mlp(h, r, w_up, w_down, w_gate=None, b_up=None, b_gate=None,
              b_down=None, *, act: str = "gelu", wscales=None):
    """h [B, D] (normed); r [B, D] (residual).  Returns r + mlp(h): the
    activation is rounded to h's dtype before the down projection, as the
    jnp reference rounds it.  ``wscales`` = (up, gate, down) per-column fp32
    scales mark the weights as int8 codes (the gate's is None without a
    gate), dequantized in the kernel."""
    if wscales is not None and h.dtype != torch.bfloat16:
        raise TypeError(f"fused_mlp: int8 weights take bfloat16 "
                        f"activations, got {h.dtype}")
    if use_kernel(h):
        if wscales is not None:
            return fused_mlp_int8_cuda(h, r, w_up, w_down, w_gate, wscales,
                                       b_up, b_gate, b_down, act=act)
        return fused_mlp_cuda(h, r, w_up, w_down, w_gate, b_up, b_gate,
                              b_down, act=act)
    return _mlp_ref(h, r, w_up, w_gate, w_down, b_up, b_gate, b_down,
                    act=act, wscales=wscales)


# kernel launches (CUDA tensors only); fused_mlp counts one per call of
# its two launches.  flash_decode counts the paged pool's launches, the
# variants count their own: the contiguous cache and the int8 weights.
fused_norm_qkv.launches = 0
flash_decode.launches = 0
fused_proj_norm.launches = 0
fused_mlp.launches = 0
flash_decode_contig_cuda.launches = 0
fused_norm_qkv_int8_cuda.launches = 0
fused_proj_norm_int8_cuda.launches = 0
fused_mlp_int8_cuda.launches = 0
