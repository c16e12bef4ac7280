#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; imports nothing of JAX.  Phases
(each one raises, and the script exits non-zero, on any failure):

1. build   — compile the seven CUDA libraries (LayerNorm and RMSNorm
             fwd/bwd; the four fused decode kernels; flash attention
             fwd/bwd; fused Adam; the block quantizer; fused Adam8bit; the
             LAMB phases), one nvcc each, started together, while
             Triton compiles the RoPE, softmax and bias_act kernels; print
             build seconds and the ptxas register / shared-memory / spill
             lines;
2. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes, fp32 and bf16, with the tolerances of TOL below
             (the flash-decode kernel at depths 1..1024 across page
             boundaries, a shuffled page table, 256- and 16-token pages),
             then CUDA-event timings (median of 50 samples of 20 calls;
             the GEMV kernels cycle through enough weight copies to miss
             the 50 MB L2, as 32 layers do) beside the plain version, the
             PyTorch library call where one exists, ``torch.matmul`` of
             the same activations and weights as a yardstick for the three
             GEMV kernels, and the bound; then the four training kernels
             at llama-1b4's training shapes (flash attention fwd and bwd
             on [4, 16, 2048, 128], RMSNorm bwd on [8192, 2048], Adam over
             a [24, 2048, 5632] leaf, three steps), fp32 and bf16, plus a
             ragged S, with bit-equal repeats of each backward, and the
             serving kernels at the training shapes (RMSNorm fwd on
             [8192, 2048], RoPE on [4, 16, 2048, 128] with sin and with
             the backward's -sin); then the four training kernels'
             timings beside SDPA and torch's fused AdamW as yardsticks;
             then the four decode kernels again at gpt2-xl's shapes and
             branches ([8, 1600], LayerNorm with a bias, tanh-GeLU without
             a gate, 25 heads of 64 with one query head per KV head) and
             Adam on its [1600] and [48, 1600] leaves;
             then the gpt2-xl kernels: LayerNorm fwd and bwd at
             [8192, 1600], [8, 1600] and ragged shapes (bwd bit-equal on a
             second call), scaled masked softmax with and without a causal
             mask at [4, 25, 1024, 1024] and at a row length that is no
             power of two, bias_act for each activation at [8192, 6400],
             flash attention fwd and bwd at [8, 25, 1024, 64], fp32 and
             bf16, and their timings beside ``F.layer_norm`` (and its
             autograd backward), ``torch.softmax`` and ``F.gelu(x + b)``;
             then the optimizers' kernels at the [24, 2048, 5632] leaf and
             a ragged one, three steps: fused Adam8bit (bf16 params with
             stochastic rounding, fp32 params; fp32 and bf16 grads; blocks
             512 and 4096), the two LAMB phases (norms bit-equal on a
             repeat) and quantize (bits 8 and 4, blocks 128 / 512 / 2048),
             and their timings beside the plain versions and the bound
             (PyTorch has no call for these functions);
3. reference — a small fp32 model served on the card (kernels) and on the
             CPU (plain versions) must give the same greedy tokens, on the
             default fused decode path and on ``use_fused_decode: False``;
             and the same small model trained 3 steps on the card (TF32
             off) and on the CPU: losses and final weights agree; each for a
             llama-shaped and a gpt2-shaped model (learned positions,
             LayerNorm, GeLU, a plain MLP); then the llama-shaped model on
             the new optimizer paths: FusedLamb and Adam8bit over fp32
             masters, Adam8bit master-free bf16;
   ops     — the ops of the public kernel library that no model path
             calls, driven through the library's wrappers:
             ``scaled_masked_softmax`` with a causal mask and ``bias_act``
             at gpt2-xl's shapes, ``quantize`` -> ``dequantize`` (8 and 4
             bits) and ``pack_int4`` -> ``unpack_int4`` on the
             [24, 2048, 5632] fp32 leaf; their launches are counted over
             this phase;
4. serve   — the main path: ``init_serving(causal_lm("llama3-8b"),
             {"dtype": "bfloat16", ...})`` with the default decode (fused)
             at full width and depth with random bf16 weights from seed 0,
             8 greedy requests, then a second wave with an exact repeat and
             a shared-prefix request; launch counters are zeroed just before
             and read just after, and must match the path's launch plan;
             then one more wave under torch.profiler (device busy share,
             top kernels, each kernel's device time per launch); then the
             unfused decode path on the same weights, a shorter wave with
             its own launch plan; then the same for ``gpt2-xl`` at full
             width and depth (LayerNorm in place of RMSNorm, no RoPE);
5. train   — the training path, after the serve phase has released its
             memory: ``deepspeed_tpu_torch.initialize(causal_lm(
             "llama-1b4"), config)`` at full width and depth, random fp32
             weights from seed 0, bf16 compute, FusedAdam, WarmupLR,
             clipping, micro 4 x gas 2 x S 2048, 5 ``train_step``s on one
             repeated batch of seeded random tokens; losses finite and
             falling, launch counters (zeroed just before, read just
             after) equal to the path's plan; then one step under
             torch.profiler; then the same for ``gpt2-xl`` at full width and
             depth (micro 8 x gas 2 x S 1024, the preset's full-layer
             remat); then llama-1b4 twice more, the same way: config A
             (``adam8bit_train``: ``bf16.master_weights: false``, a bf16
             accumulator, Adam8bit; the optimizer state's bytes must equal
             the count from the leaf shapes and every master be bf16) and
             config B (``lamb_train``: FusedLamb over fp32 masters), each
             with its peak memory beside the FusedAdam phase's;
6. report  — the card's name and power limit, the kernels JSON line, and
             last the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# kernel vs plain version: fp32 elementwise 1e-5 (same formula, another
# reduction order); fp32 GEMV 1e-4 (sums of up to 14336 products in another
# order: ~sqrt(K) * 2^-24 of the partial sums); fp32 attention 2e-4 (online
# vs dense softmax, the bound tests/unit/test_fused_decode.py holds); bf16
# 2e-2 (one bf16 rounding of each output, and of the rows rounded before a
# product)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GEMV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# llama3-8b decode shapes: 8 slots
B, D, H, HKV, DH, F = 8, 4096, 32, 8, 128, 14336
NQKV = (H + 2 * HKV) * DH


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, samples=50, inner=20, warmup=10):
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cycler(items):
    """A callable returning the next item on each call (round robin)."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


def phase_build(torch, dev):
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import rope, softmax

    results = {}

    def cuda_build(name):
        t0 = time.perf_counter()
        try:
            results[name] = build.load_library(name)
        except Exception as e:          # re-raised on the main thread
            results[name] = e
        results[name + "_s"] = time.perf_counter() - t0

    libs = ("layer_norm", "decode", "flash_attention", "fused_adam",
            "quantizer", "fused_adam8bit", "fused_lamb")
    threads = [threading.Thread(target=cuda_build, args=(n,)) for n in libs]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    x = torch.ones(1, 1, 8, 128, device=dev, dtype=torch.bfloat16)
    c = torch.ones(8, 64, device=dev, dtype=torch.bfloat16)
    rope.rope_triton(x, c, c)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    softmax.scaled_masked_softmax_triton(c, c, 1.0)
    softmax.scaled_masked_softmax_triton(c)
    softmax.bias_act_triton(c, c[0], "gelu")
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t1
    for th in threads:
        th.join()
    for name in libs:
        if isinstance(results[name], Exception):
            raise results[name]
        lib = results[name]
        print(f"build: nvcc {lib.path.name} {results[name + '_s']:.2f}s "
              f"(0.00 = reused)")
        # one line per entry function; of decode's 60 instantiations only
        # the bf16 ones (the serving path's) are printed
        entry, n_entries, spilled = "", 0, []
        for ln in lib.ptxas_info:
            if "Compiling entry" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
                n_entries += 1
            elif "spill stores" in ln:
                m = re.search(r"(\d+) bytes spill stores", ln)
                if m and int(m.group(1)):
                    spilled.append(f"{entry[:60]}: {ln}")
            elif "Used" in ln and (name != "decode" or "bfloat16" in entry):
                print(f"  ptxas: {entry[:70]}: {ln.split(':', 1)[1].strip()}")
        print(f"  ptxas: {n_entries} entry functions, {len(spilled)} spill"
              + "".join(f"\n  ptxas spill: {s}" for s in spilled))
    print(f"build: triton rope compile+first launch {triton_s:.2f}s; softmax "
          f"(with and without a mask) and bias_act {ops_s:.2f}s")
    out = {name: results[name + "_s"] for name in libs}
    out["rope"] = triton_s
    out["softmax"] = ops_s
    return out


def _randn(torch, shape, gen, dev, scale=1.0):
    return torch.randn(shape, device=dev, generator=gen).mul_(scale)


def _assert_close(torch, got, want, tol, what):
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        raise RuntimeError(f"chip_smoke: {what} disagrees with its plain "
                           f"version: {e}") from None
    return float((got.float() - want.float()).abs().max())


def check_old_kernels(torch, dev, gen):
    """RMSNorm and RoPE against their plain versions; bf16 max abs errors."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm, rope

    errs = {"rms_norm": 0.0, "rope": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for rows in (8, 64):
            x = _randn(torch, (rows, D), gen, dev, 3).to(dt)
            g = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(dt)
            y = layer_norm.rms_norm_cuda(x, g, 1e-5)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, layer_norm.rms_norm_plain(x, g, 1e-5),
                              TOL[dtype_name], "rms_norm")
            if dtype_name == "bfloat16":
                errs["rms_norm"] = max(errs["rms_norm"], e)
        for heads in (H, HKV):
            x = _randn(torch, (1, heads, 64, DH), gen, dev).to(dt)
            cos, sin = rope.rope_angles(torch.arange(64, device=dev), DH,
                                        theta=500000.0)
            cos, sin = cos.to(dt), sin.to(dt)
            y = rope.rope_triton(x, cos, sin)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, rope.rope_plain(x, cos, sin),
                              TOL[dtype_name], "rope")
            if dtype_name == "bfloat16":
                errs["rope"] = max(errs["rope"], e)
    return errs


# the decode shapes of the two served models (8 slots each): widths, heads,
# the norm kind and the MLP (gated silu, or a plain tanh-GeLU MLP)
DECODE_MODELS = {
    "llama3-8b": dict(D=D, H=H, HKV=HKV, DH=DH, F=F, kind="rmsnorm",
                      act="silu", glu=True),
    "gpt2-xl": dict(D=1600, H=25, HKV=25, DH=64, F=6400, kind="layernorm",
                    act="gelu", glu=False)}


def decode_inputs(torch, dev, gen, dt, copies=1, model="llama3-8b"):
    """Activations and ``copies`` sets of one layer's weights at ``model``'s
    decode shapes (weights scaled as the model's init; ``nbias`` is the
    norm's bias, which only LayerNorm has; ``wg`` only a gated MLP)."""
    m = DECODE_MODELS[model]
    d, f, hd = m["D"], m["F"], m["H"] * m["DH"]
    nqkv = (m["H"] + 2 * m["HKV"]) * m["DH"]

    def w(shape, fan_in):
        return [(_randn(torch, shape, gen, dev, fan_in ** -0.5)).to(dt)
                for _ in range(copies)]
    return {
        "x": _randn(torch, (B, d), gen, dev, 2).to(dt),
        "scale": (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(dt),
        "nbias": ((0.1 * torch.randn(d, device=dev, generator=gen)).to(dt)
                  if m["kind"] == "layernorm" else None),
        "wqkv": w((d, nqkv), d), "wo": w((hd, d), hd),
        "ctx": _randn(torch, (B, hd), gen, dev).to(dt),
        "resid": _randn(torch, (B, d), gen, dev, 2).to(dt),
        "h": _randn(torch, (B, d), gen, dev).to(dt),
        "wu": w((d, f), d), "wg": w((d, f), d) if m["glu"] else [None],
        "wd": w((f, d), f),
    }


def paged_inputs(torch, dev, gen, dt, page, pos, layers=2, model="llama3-8b"):
    """A stacked [layers, P, Hkv, page, Dh] pool behind a shuffled page table
    with a 1024-token window per slot, q [B, H, Dh], and pos [B]."""
    import numpy as np

    m = DECODE_MODELS[model]
    maxp = 1024 // page
    P = B * maxp + 1
    k = _randn(torch, (layers, P, m["HKV"], page, m["DH"]), gen, dev).to(dt)
    v = _randn(torch, (layers, P, m["HKV"], page, m["DH"]), gen, dev).to(dt)
    perm = np.random.default_rng(page).permutation(B * maxp) + 1
    table = torch.from_numpy(perm.reshape(B, maxp)).to(dev)
    q = _randn(torch, (B, m["H"], m["DH"]), gen, dev).to(dt)
    return q, k, v, torch.tensor(pos, device=dev), table


def check_decode_kernels(torch, dev, gen, model):
    """The four fused decode kernels against their plain versions at
    ``model``'s path shapes and branches (norm kind, activation, gate or
    none, heads per KV head), fp32 and bf16; returns the bf16 max abs
    errors."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    m = DECODE_MODELS[model]
    kind, act, dh = m["kind"], m["act"], m["DH"]
    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        bf = dtype_name == "bfloat16"
        t = decode_inputs(torch, dev, gen, dt, model=model)
        wqkv, wo = t["wqkv"][0], t["wo"][0]
        wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
        nbias = t["nbias"]
        ref_bias = torch.zeros_like(t["scale"]) if nbias is None else nbias
        out = {}
        y = dk.fused_norm_qkv_cuda(t["x"], t["scale"], nbias, wqkv,
                                   kind=kind, eps=1e-5)
        torch.cuda.synchronize()
        out["fused_norm_qkv"] = _assert_close(
            torch, y, dk._norm_qkv_ref(t["x"], t["scale"], ref_bias, wqkv,
                                       None, kind=kind, eps=1e-5),
            GEMV_TOL[dtype_name], f"fused_norm_qkv {model} {dtype_name}")
        r, h = dk.fused_proj_norm_cuda(t["ctx"], t["resid"], wo, None,
                                       t["scale"], nbias, kind=kind,
                                       eps=1e-5, parallel=False)
        torch.cuda.synchronize()
        wr, wh = dk._proj_norm_ref(t["ctx"], t["resid"], wo, None, t["scale"],
                                   ref_bias, kind=kind, eps=1e-5,
                                   parallel=False)
        out["fused_proj_norm"] = max(
            _assert_close(torch, r, wr, GEMV_TOL[dtype_name],
                          f"fused_proj_norm r {model} {dtype_name}"),
            _assert_close(torch, h, wh, GEMV_TOL[dtype_name],
                          f"fused_proj_norm h {model} {dtype_name}"))
        y = dk.fused_mlp_cuda(t["h"], t["resid"], wu, wd, wg, act=act)
        torch.cuda.synchronize()
        out["fused_mlp"] = _assert_close(
            torch, y, dk._mlp_ref(t["h"], t["resid"], wu, wg, wd, None, None,
                                  None, act=act),
            GEMV_TOL[dtype_name], f"fused_mlp {model} {dtype_name}")
        del t, wqkv, wo, wu, wg, wd
        # depths 1..1024 (pos 0..1023) across page boundaries
        fd = 0.0
        for page in (256, 16):
            for alibi in (False, True):
                q, k, v, pos, table = paged_inputs(
                    torch, dev, gen, dt, page,
                    [0, 254, 255, 256, 299, 300, 1022, 1023], model=model)
                for layer in (0, 1):
                    y = dk.flash_decode_paged_cuda(
                        q, k, v, pos, table, scale=dh ** -0.5, layer=layer,
                        alibi=alibi)
                    torch.cuda.synchronize()
                    fd = max(fd, _assert_close(
                        torch, y, dk._flash_decode_paged_ref(
                            q, k, v, pos, table, scale=dh ** -0.5,
                            layer=layer, alibi=alibi),
                        ATTN_TOL[dtype_name],
                        f"flash_decode {model} {dtype_name} page {page} "
                        f"alibi {alibi} layer {layer}"))
        out["flash_decode"] = fd
        if bf:
            errs = out
    print(f"decode kernels vs plain at {model}'s shapes (D {m['D']}, "
          f"{m['H']}/{m['HKV']} heads of {dh}, F {m['F']}, {kind}, {act}"
          f"{' gated' if m['glu'] else ', no gate'}): fp32 GEMV within 1e-4, "
          "attention 2e-4, bf16 within 2e-2; bf16 max abs err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def time_old_kernels(torch, dev, gen, errs):
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm, rope

    out = {}
    bf = torch.bfloat16
    x = _randn(torch, (B, D), gen, dev).to(bf)
    g = torch.ones(D, device=dev, dtype=bf)
    lib_ms = None
    if hasattr(F_, "rms_norm"):
        lib_ms = time_ms(torch, lambda: F_.rms_norm(x, (D,), g, 1e-5))
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + g.numel() * 2, 4 * x.numel())
    out["rms_norm"] = {
        "shape": "x[8,4096] bf16",
        "ms": time_ms(torch, lambda: layer_norm.rms_norm_cuda(x, g, 1e-5)),
        "plain_ms": time_ms(torch, lambda: layer_norm.rms_norm_plain(x, g, 1e-5)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rms_norm"]}
    q = _randn(torch, (1, H, 64, DH), gen, dev).to(bf)
    cos, sin = rope.rope_angles(torch.arange(64, device=dev), DH,
                                theta=500000.0)
    cos, sin = cos.to(bf), sin.to(bf)
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * cos.numel() * 2,
                          3 * q.numel())
    out["rope"] = {
        "shape": "q[1,32,64,128] bf16",
        "ms": time_ms(torch, lambda: rope.rope_triton(q, cos, sin)),
        "plain_ms": time_ms(torch, lambda: rope.rope_plain(q, cos, sin)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rope"]}
    return out


def time_decode_kernels(torch, dev, gen, errs):
    """bf16 at the llama3-8b decode shapes.  The GEMV kernels cycle through
    weight copies totalling > 100 MB, so each call streams its weights from
    HBM as the 32-layer path does."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    out = {}
    zeros = torch.zeros(D, device=dev, dtype=bf)

    # fused_norm_qkv: x [8,4096] . wqkv [4096,6144]
    t = decode_inputs(torch, dev, gen, bf, copies=3)
    x, s = t["x"], t["scale"]
    nw = cycler(t["wqkv"])
    nbytes = (x.numel() + s.numel() + D * NQKV + B * NQKV) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * B * D * NQKV, BF16_FLOPS_PER_S)
    out["fused_norm_qkv"] = {
        "shape": "x[8,4096] . wqkv[4096,6144] bf16",
        "ms": time_ms(torch, lambda: dk.fused_norm_qkv_cuda(
            x, s, None, nw(), kind="rmsnorm", eps=1e-5)),
        "plain_ms": time_ms(torch, lambda: dk._norm_qkv_ref(
            x, s, zeros, nw(), None, kind="rmsnorm", eps=1e-5), samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(x, nw())),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_norm_qkv"]}
    del t, nw

    # fused_proj_norm: ctx [8,4096] . wo [4096,4096] + resid, norm
    t = decode_inputs(torch, dev, gen, bf, copies=4)
    ctx, resid = t["ctx"], t["resid"]
    nw = cycler(t["wo"])
    nbytes = (ctx.numel() + resid.numel() + H * DH * D + D + 2 * B * D) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * B * H * DH * D, BF16_FLOPS_PER_S)
    out["fused_proj_norm"] = {
        "shape": "ctx[8,4096] . wo[4096,4096] bf16",
        "ms": time_ms(torch, lambda: dk.fused_proj_norm_cuda(
            ctx, resid, nw(), None, s, None, kind="rmsnorm", eps=1e-5,
            parallel=False)),
        "plain_ms": time_ms(torch, lambda: dk._proj_norm_ref(
            ctx, resid, nw(), None, s, zeros, kind="rmsnorm", eps=1e-5,
            parallel=False), samples=10),
        "matmul_ms": time_ms(torch, lambda: torch.matmul(ctx, nw())),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_proj_norm"]}
    del t, nw

    # fused_mlp: h [8,4096] . (wg, wu [4096,14336]) -> a . wd [14336,4096]
    t = decode_inputs(torch, dev, gen, bf)
    h, r = t["h"], t["resid"]
    wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
    a = torch.randn(B, F, device=dev, generator=gen).to(bf)
    nbytes = (2 * h.numel() + 3 * D * F + B * D) * 2
    b_ms, b_by = bound_ms(nbytes, 6 * B * D * F, BF16_FLOPS_PER_S)
    out["fused_mlp"] = {
        "shape": "h[8,4096] . wg,wu[4096,14336], a . wd[14336,4096] bf16",
        "ms": time_ms(torch, lambda: dk.fused_mlp_cuda(h, r, wu, wd, wg,
                                                       act="silu")),
        "plain_ms": time_ms(torch, lambda: dk._mlp_ref(
            h, r, wu, wg, wd, None, None, None, act="silu"), samples=10),
        "matmul_ms": time_ms(torch, lambda: (torch.matmul(h, wg),
                                             torch.matmul(h, wu),
                                             torch.matmul(a, wd))),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_mlp"]}
    del t, wu, wg, wd

    # flash_decode: 8 slots 300 deep, 256-token pages (the serve cell's
    # pool), layer 1 of a stacked pool; the bound counts the K/V rows this
    # data needs (keys 0..pos of each slot)
    q, k, v, pos, table = paged_inputs(torch, dev, gen, bf, 256, [299] * B)
    keys = int((pos + 1).sum())
    nbytes = (2 * q.numel() + 2 * keys * HKV * DH) * 2 + 8 * (
        pos.numel() + B * ((int(pos.max()) // 256) + 1))
    b_ms, b_by = bound_ms(nbytes, 4 * keys * H * DH, BF16_FLOPS_PER_S)
    out["flash_decode"] = {
        "shape": "q[8,32,128], 8 slots x 300 keys, 256-token pages, bf16",
        "ms": time_ms(torch, lambda: dk.flash_decode_paged_cuda(
            q, k, v, pos, table, scale=DH ** -0.5, layer=1)),
        "plain_ms": time_ms(torch, lambda: dk._flash_decode_paged_ref(
            q, k, v, pos, table, scale=DH ** -0.5, layer=1, alibi=False)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["flash_decode"]}
    return out

# llama-1b4 training shapes: micro 4 x S 2048, D 2048, 16 heads of 128,
# the [24, 2048, 5632] MLP leaf for Adam
TB, TS, TD, TH, TDH, TL, TF = 4, 2048, 2048, 16, 128, 24, 5632
# flash gradients: relative Frobenius error, fp32 1e-4 (sums of up to S
# recomputed products in another order), bf16 2e-2 (p and ds rounded to
# bf16 before each product, as the reference kernel does); RMSNorm dγ (a
# sum over 8192 rows) relative 1e-4 fp32 / 2e-2 bf16; Adam 1e-6 (the same
# fp32 formula, three steps)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash output o, relative Frobenius on top of the elementwise ATTN_TOL:
# late causal rows average many keys, so |o| there is ~0.04 and a fixed
# 2e-2 atol alone would hide an error of a quarter of them; fp32 1e-5, bf16
# 1e-2 (p rounded to bf16 before P.V, then o to bf16; measured ~3e-3)
O_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ADAM_TOL = 1e-6


def _rel_err(got, want):
    return float((got.float() - want.float()).norm()
                 / max(float(want.float().norm()), 1.0))


def _lse_plain(torch, q, k, scale):
    S = q.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.logsumexp(logits.masked_fill(~mask, -1e30), -1)


def check_flash(torch, dev, gen, dtype_name, shape):
    """Flash fwd (o, lse) and bwd (dq, dk, dv) against mha_reference and
    its autograd on the same inputs; two backward calls must give the same
    bits.  Returns (o max abs err, grads max abs err, grads max rel err)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    dt = getattr(torch, dtype_name)
    q, k, v, do = (_randn(torch, shape, gen, dev).to(dt) for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    want_o = fa.mha_reference(q, k, v)
    e_o = _assert_close(torch, o, want_o, ATTN_TOL[dtype_name],
                        f"flash fwd o {dtype_name} {shape}")
    rel_o = _rel_err(o, want_o)
    check(rel_o < O_REL_TOL[dtype_name], f"flash fwd o {dtype_name} {shape}: "
          f"relative error {rel_o}")
    _assert_close(torch, lse, _lse_plain(torch, q, k, scale), 1e-4,
                  f"flash fwd lse {dtype_name} {shape}")
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, True, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"flash bwd {dtype_name} {shape}: two calls differ")
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    fa.mha_reference(*ref).backward(do.float())
    rel = [_rel_err(g, r.grad) for g, r in zip(grads, ref)]
    check(max(rel) < GRAD_TOL[dtype_name], f"flash bwd {dtype_name} {shape}: "
          f"relative errors dq/dk/dv {rel}")
    e_g = max(float((g.float() - r.grad).abs().max()) for g, r in zip(grads, ref))
    return e_o, rel_o, e_g, max(rel)


def check_train_kernels(torch, dev, gen):
    """The training path's kernels against their plain versions at the
    training shapes (and a ragged S), fp32 and bf16: the four new ones, and
    RMSNorm fwd and RoPE (fwd, and bwd through -sin) that serving also
    runs; bf16 max abs errors."""
    from deepspeed_tpu_torch.models.layers import rope_cache
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import rope

    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in ((TB, TH, TS, TDH), (2, 3, 200, TDH)):
            e_o, rel_o, e_g, rel = check_flash(torch, dev, gen, dtype_name, shape)
            print(f"train kernels: flash {dtype_name} {list(shape)}: o max abs "
                  f"err {e_o:.3g}, relative (Frobenius) {rel_o:.3g}; dq/dk/dv "
                  f"max abs err {e_g:.3g}, max relative (Frobenius) {rel:.3g}")
            if dtype_name == "bfloat16" and shape[2] == TS:
                errs["flash_attention_fwd"], errs["flash_attention_bwd"] = e_o, e_g
        # RoPE on q [4, 16, 2048, 128] with the path's cos/sin (rope_cache,
        # cast to the compute dtype): the forward, and the backward's -sin
        x = _randn(torch, (TB, TH, TS, TDH), gen, dev).to(dt)
        cos, sin = rope_cache(TS, TDH, 10000.0, device=dev)
        cos, sin = cos.to(dt), sin.to(dt)
        for sign, s in (("sin", sin), ("-sin", -sin)):
            e = _assert_close(torch, rope.rope_triton(x, cos, s),
                              rope.rope_plain(x, cos, s), TOL[dtype_name],
                              f"rope ({sign}) {dtype_name} train shape")
            print(f"train kernels: rope {dtype_name} {list(x.shape)} ({sign}): "
                  f"max abs err {e:.3g}")
            if dtype_name == "bfloat16":
                errs["rope_train"] = max(errs.get("rope_train", 0.0), e)
        x = _randn(torch, (TB * TS, TD), gen, dev, 3).to(dt)
        g = (1 + 0.1 * torch.randn(TD, device=dev, generator=gen)).to(dt)
        e = _assert_close(torch, ln.rms_norm_cuda(x, g, 1e-5),
                          ln.rms_norm_plain(x, g, 1e-5), TOL[dtype_name],
                          f"rms_norm {dtype_name} train shape")
        print(f"train kernels: rms_norm {dtype_name} [8192, 2048]: max abs err "
              f"{e:.3g}")
        if dtype_name == "bfloat16":
            errs["rms_norm_train"] = e
        dy = _randn(torch, (TB * TS, TD), gen, dev).to(dt)
        dx, dg = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        dx2, dg2 = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        check(torch.equal(dx, dx2) and torch.equal(dg, dg2),
              f"rms_norm_bwd {dtype_name}: two calls differ")
        want_dx, want_dg = ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
        e = _assert_close(torch, dx, want_dx, TOL[dtype_name],
                          f"rms_norm_bwd dx {dtype_name}")
        rel = _rel_err(dg, want_dg)
        check(rel < GRAD_TOL[dtype_name], f"rms_norm_bwd dγ {dtype_name}: "
              f"relative error {rel}")
        print(f"train kernels: rms_norm_bwd {dtype_name} [8192, 2048]: dx max "
              f"abs err {e:.3g}, dγ relative {rel:.3g}")
        if dtype_name == "bfloat16":
            errs["rms_norm_bwd"] = e
        del x, dy, dx, dx2, want_dx
    # Adam: the path's case (fp32 masters and accumulator) and bf16 grads
    n = TL * TD * TF
    for g_name in ("float32", "bfloat16"):
        p = _randn(torch, (n,), gen, dev)
        m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        ref = [p.clone(), m.clone(), v.clone()]
        for step in (1, 2, 3):
            gr = _randn(torch, (n,), gen, dev, 1e-3).to(getattr(torch, g_name))
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, adam_w_mode=True)
            adam.fused_adam_update_cuda(p, gr, m, v, step, **kw)
            adam.fused_adam_update_plain(ref[0], gr, ref[1], ref[2], step, **kw)
        torch.cuda.synchronize()
        e = max(_assert_close(torch, got, want, ADAM_TOL, f"fused_adam {what} "
                              f"(grads {g_name})")
                for got, want, what in zip((p, m, v), ref, ("p", "m", "v")))
        print(f"train kernels: fused_adam fp32 params, {g_name} grads, "
              f"[{n}] x 3 steps: p/m/v max abs err {e:.3g}")
        if g_name == "float32":
            errs["fused_adam"] = e
        del p, m, v, ref, gr
    torch.cuda.empty_cache()
    return errs


def time_train_kernels(torch, dev, gen, errs):
    """bf16 at the llama-1b4 training shapes (Adam: fp32 masters and grads
    over the [24, 2048, 5632] MLP leaf)."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    bf = torch.bfloat16
    out = {}
    x = _randn(torch, (TB * TS, TD), gen, dev).to(bf)
    dy = _randn(torch, (TB * TS, TD), gen, dev).to(bf)
    g = torch.ones(TD, device=dev, dtype=bf)
    b_ms, b_by = bound_ms((3 * x.numel() + 2 * TD) * 2, 10 * x.numel())
    out["rms_norm_bwd"] = {
        "shape": "x, dy [8192,2048] bf16",
        "ms": time_ms(torch, lambda: ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)),
        "plain_ms": time_ms(torch, lambda: ln.rms_norm_bwd_plain(x, g, dy, 1e-5),
                            samples=10),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rms_norm_bwd"]}
    del x, dy

    shape = (TB, TH, TS, TDH)
    q, k, v, do = (_randn(torch, shape, gen, dev).to(bf) for _ in range(4))
    scale = TDH ** -0.5
    causal_pairs = TB * TH * TS * (TS + 1) // 2        # (row, key) pairs visible
    fwd_flops = 4 * causal_pairs * TDH                 # q k^T and p v
    b_ms, b_by = bound_ms(4 * q.numel() * 2 + TB * TH * TS * 4, fwd_flops,
                          BF16_FLOPS_PER_S)
    out["flash_attention_fwd"] = {
        "shape": "q, k, v [4,16,2048,128] bf16, causal",
        "ms": time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: fa.mha_reference(q, k, v), samples=5,
                            inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: F_.scaled_dot_product_attention(
            q, k, v, is_causal=True), samples=20, inner=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["flash_attention_fwd"]}
    o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
    # the backward's least work: the five products s, dp, dv, dq, dk
    b_ms, b_by = bound_ms(8 * q.numel() * 2 + TB * TH * TS * 4,
                          2.5 * fwd_flops, BF16_FLOPS_PER_S)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = fa.mha_reference(*ref)
    lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib, is_causal=True)
    out["flash_attention_bwd"] = {
        "shape": "q, k, v, o, do [4,16,2048,128] bf16, causal (two launches)",
        "ms": time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, True, scale), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
            ref_out, ref, do.float(), retain_graph=True), samples=5, inner=3,
            warmup=2),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, do, retain_graph=True), samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["flash_attention_bwd"]}
    del q, k, v, do, o, lse, ref, ref_out, lib, lib_out
    torch.cuda.empty_cache()

    n = TL * TD * TF
    p, gr = _randn(torch, (n,), gen, dev), _randn(torch, (n,), gen, dev, 1e-3)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              adam_w_mode=True)
    b_ms, b_by = bound_ms(28 * n, 16 * n)
    lp = p.clone().requires_grad_()
    lp.grad = gr.clone()
    lib_opt = torch.optim.AdamW([lp], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
    out["fused_adam"] = {
        "shape": f"fp32 params, grads, m, v [{n}] (the [24,2048,5632] MLP leaf)",
        "ms": time_ms(torch, lambda: adam.fused_adam_update_cuda(
            p, gr, m, v, 5, **kw), samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: adam.fused_adam_update_plain(
            p, gr, m, v, 5, **kw), samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lib_opt.step, samples=20, inner=5),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["fused_adam"]}
    del p, gr, m, v, lp, lib_opt
    torch.cuda.empty_cache()
    return out


# the optimizers' kernels: every operation of fused_adam8bit, fused_lamb
# and quantize is an IEEE-rounded intrinsic (no FMA contraction), so the
# codes, scales, moments and stochastically rounded params EQUAL their plain
# versions'; LAMB's p is held within 1e-5 relative (its norms are summed in
# another order than torch.linalg.vector_norm's), the norms within 1e-5
# relative and bit-equal on a repeat
LAMB_TOL = 1e-5
# the leaf sizes: the [24, 2048, 5632] MLP leaf, and a ragged one (at block
# 512 neither a multiple of the block nor giving 32-row multiples)
BIG_LEAF, RAGGED = TL * TD * TF, 1000003


def _adam8bit_state(torch, dev, n, block):
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8

    rows = k8.state_rows(n, block)
    codes = torch.zeros(rows, block, dtype=torch.int8, device=dev)
    return [codes, torch.ones(rows, 1, device=dev), codes.clone(),
            torch.ones(rows, 1, device=dev)]


def check_optimizer_kernels(torch, dev, gen):
    """fused_adam8bit, the two LAMB phases and quantize against their plain
    versions at the path's largest leaf and a ragged one, three steps;
    returns the max abs errors (all 0 when equal)."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8
    from deepspeed_tpu_torch.ops.kernels import fused_lamb as kl
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq

    errs = {"fused_adam8bit": 0.0, "fused_lamb_phase1": 0.0,
            "fused_lamb_scale": 0.0, "quantize": 0.0}
    # Adam8bit: config A (bf16 params and grads, stochastic rounding), bf16
    # params with fp32 grads, and fp32 params (no rounding) with fp32 and
    # bf16 grads; block 512 (the default) and the largest, 4096
    cases = [(BIG_LEAF, 512, "bfloat16", "bfloat16", True),
             (BIG_LEAF, 512, "float32", "float32", False),
             (RAGGED, 512, "bfloat16", "float32", True),
             (RAGGED, 4096, "float32", "bfloat16", False)]
    for n, block, p_name, g_name, sr in cases:
        p = _randn(torch, (n,), gen, dev).to(getattr(torch, p_name))
        st = _adam8bit_state(torch, dev, n, block)
        rp, rst = p.clone(), [t.clone() for t in st]
        for step in (1, 2, 3):
            g = _randn(torch, (n,), gen, dev, 1e-3).to(getattr(torch, g_name))
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, seed=k8.sr_seed(step, 3), sr=sr)
            k8.fused_adam8bit_update_cuda(p, g, *st, step, **kw)
            k8.fused_adam8bit_update_plain(rp, g, *rst, step, **kw)
        torch.cuda.synchronize()
        e = float((p.float() - rp.float()).abs().max())
        codes = [int((a.int() - b.int()).abs().max()) for a, b in
                 ((st[0], rst[0]), (st[2], rst[2]))]
        check(torch.equal(p, rp) and all(torch.equal(a, b) for a, b in
                                         zip(st, rst)),
              f"fused_adam8bit {p_name} params / {g_name} grads, n {n}, block "
              f"{block}, sr {sr}: p max abs err {e}, codes max diff {codes}")
        print(f"optimizer kernels: fused_adam8bit {p_name} params, {g_name} "
              f"grads, sr {sr}, [{n}] at block {block} x 3 steps: p, codes and "
              f"scales equal to the plain version")
        del p, st, rp, rst, g
    # LAMB: fp32 (config B), the big leaf and the ragged one
    for n in (BIG_LEAF, RAGGED):
        p = _randn(torch, (n,), gen, dev)
        m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        rp, rm, rv = p.clone(), m.clone(), v.clone()
        for step in (1, 2, 3):
            g = _randn(torch, (n,), gen, dev, 1e-3)
            kw = dict(beta1=0.9, beta2=0.95, eps=1e-6, weight_decay=0.1)
            m0, v0 = m.clone(), v.clone()
            stats = kl.lamb_phase1_cuda(p, g, m, v, step, lr=3e-4 * step, **kw)
            again = kl.lamb_phase1_cuda(p, g, m0, v0, step, lr=3e-4 * step, **kw)
            kl.lamb_scale_cuda(p, m, v, stats, step, **kw)
            want = kl.lamb_phase1_plain(rp, g, rm, rv, step, lr=3e-4 * step, **kw)
            kl.lamb_scale_plain(rp, rm, rv, want, step, **kw)
            torch.cuda.synchronize()
            check(torch.equal(stats, again), f"lamb phase 1 [{n}]: two calls "
                  f"give other norms: {stats.tolist()} vs {again.tolist()}")
            _assert_close(torch, stats, want, LAMB_TOL, f"lamb stats [{n}]")
            del m0, v0
        check(torch.equal(m, rm) and torch.equal(v, rv),
              f"lamb phase 1 [{n}]: moments differ from the plain version")
        rel = _rel_err(p, rp)
        e = _assert_close(torch, p, rp, LAMB_TOL, f"lamb scale [{n}]")
        check(rel < LAMB_TOL, f"lamb [{n}]: relative error {rel}")
        print(f"optimizer kernels: fused_lamb fp32 [{n}] x 3 steps: moments "
              f"equal, norms bit-equal on a repeat, stats {stats.tolist()} vs "
              f"plain {want.tolist()}; p max abs err {e:.3g}, relative "
              f"(Frobenius) {rel:.3g}")
        if n == BIG_LEAF:
            errs["fused_lamb_scale"] = e
            errs["fused_lamb_phase1"] = float((stats - want).abs().max())
        del p, m, v, rp, rm, rv, g
    # quantize: bits 8 and 4 at blocks 128 / 512 / 2048, the big fp32 leaf
    # at the library's default block (2048) and a ragged bf16 size
    x = _randn(torch, (BIG_LEAF,), gen, dev, 3)
    xr = _randn(torch, (RAGGED,), gen, dev, 3).to(torch.bfloat16)
    for bits in (8, 4):
        for t, block in ((x, 2048), (xr, 128), (xr, 512), (xr, 2048)):
            q, sc, pad = kq.quantize_cuda(t, bits, block)
            wq, ws, wpad = kq.quantize_plain(t, bits, block)
            torch.cuda.synchronize()
            check(pad == wpad and torch.equal(q, wq) and torch.equal(sc, ws),
                  f"quantize bits {bits} block {block} [{t.numel()}] "
                  f"{t.dtype}: codes or scales differ from the plain version")
        print(f"optimizer kernels: quantize bits {bits}, fp32 [{BIG_LEAF}] at "
              f"block 2048 and bf16 [{RAGGED}] at 128 / 512 / 2048: codes and "
              f"scales equal")
    del x, xr, q, sc, wq, ws
    torch.cuda.empty_cache()
    return errs


def time_optimizer_kernels(torch, dev, gen, errs):
    """The three optimizer kernels at the [24, 2048, 5632] leaf: Adam8bit as
    config A runs it (bf16 params and grads, stochastic rounding) and over
    fp32 masters, LAMB's two phases in fp32, quantize on fp32 at block
    2048.  PyTorch has no call computing the same functions."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam8bit as k8
    from deepspeed_tpu_torch.ops.kernels import fused_lamb as kl
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq

    n = BIG_LEAF
    out = {}
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    for p_name, bpp in (("bfloat16", 10), ("float32", 16)):
        dt = getattr(torch, p_name)
        p = _randn(torch, (n,), gen, dev).to(dt)
        g = _randn(torch, (n,), gen, dev, 1e-3).to(dt)
        st = _adam8bit_state(torch, dev, n, 512)
        sr = p_name == "bfloat16"
        rows = st[0].shape[0]
        # each input read once, each output written once: p, g, the two
        # codes and the two scales; ~40 fp32 operations an element
        b_ms, b_by = bound_ms(bpp * n + 16 * rows, 40 * n)
        r = {"shape": f"{p_name} params and grads [{n}], block 512"
                      + (", stochastic rounding" if sr else ""),
             "ms": time_ms(torch, lambda: k8.fused_adam8bit_update_cuda(
                 p, g, *st, 5, seed=7, sr=sr, **kw), samples=20, inner=5),
             "plain_ms": time_ms(torch, lambda: k8.fused_adam8bit_update_plain(
                 p, g, *st, 5, seed=7, sr=sr, **kw), samples=3, inner=2,
                 warmup=1),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "max_abs_err": errs["fused_adam8bit"]}
        if sr:
            out["fused_adam8bit"] = r
        else:
            out["fused_adam8bit"]["fp32_masters"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
        del p, g, st
        torch.cuda.empty_cache()

    p, g = _randn(torch, (n,), gen, dev), _randn(torch, (n,), gen, dev, 1e-3)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    lkw = dict(beta1=0.9, beta2=0.95, eps=1e-6, weight_decay=0.1)
    stats = kl.lamb_phase1_cuda(p, g, m, v, 5, lr=3e-4, **lkw)
    b_ms, b_by = bound_ms(24 * n, 20 * n)            # reads p g m v, writes m v
    out["fused_lamb_phase1"] = {
        "shape": f"fp32 params, grads, m, v [{n}] (phase 1 and the reduce)",
        "ms": time_ms(torch, lambda: kl.lamb_phase1_cuda(p, g, m, v, 5, lr=3e-4,
                                                         **lkw),
                      samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: kl.lamb_phase1_plain(
            p, g, m, v, 5, lr=3e-4, **lkw), samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_lamb_phase1"]}
    b_ms, b_by = bound_ms(16 * n, 12 * n)            # reads p m v, writes p
    out["fused_lamb_scale"] = {
        "shape": f"fp32 params, m, v [{n}]",
        "ms": time_ms(torch, lambda: kl.lamb_scale_cuda(p, m, v, stats, 5, **lkw),
                      samples=20, inner=5),
        "plain_ms": time_ms(torch, lambda: kl.lamb_scale_plain(
            p, m, v, stats, 5, **lkw), samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["fused_lamb_scale"],
        # the whole LAMB update must read p, g, m, v and write p, m, v
        "whole_update_bound_ms": bound_ms(28 * n, 32 * n)[0]}
    del p, g, m, v
    torch.cuda.empty_cache()

    x = _randn(torch, (n,), gen, dev, 3)
    nb = -(-n // 2048)
    b_ms, b_by = bound_ms(5 * n + 4 * nb, 4 * n)
    out["quantize"] = {
        "shape": f"fp32 x [{n}], 8 bits, block 2048",
        "ms": time_ms(torch, lambda: kq.quantize_cuda(x, 8, 2048), samples=20,
                      inner=5),
        "plain_ms": time_ms(torch, lambda: kq.quantize_plain(x, 8, 2048),
                            samples=3, inner=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["quantize"]}
    del x
    torch.cuda.empty_cache()
    return out


# gpt2-xl shapes: micro 8 x S 1024, D 1600, 25 heads of 64, F 6400; decode
# rows = 8 slots; softmax over the scores of 4 sequences
GB, GS, GD, GH, GDH, GF, GSB = 8, 1024, 1600, 25, 64, 6400, 4
# softmax, beside the elementwise TOL: each output within one rounding of
# its own size (fp32 1e-5 relative; bf16 2^-8 relative, taken as 8e-3), with
# a 1e-6 floor: a 1024-wide row's probabilities are ~1e-3, and an absolute
# 2e-2 alone would pass them wholly wrong
SOFTMAX_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _ln_inputs(torch, dev, gen, dt, shape):
    n = shape[-1]
    x = (_randn(torch, shape, gen, dev, 3) + 1.5).to(dt)
    g = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(dt)
    b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(dt)
    dy = _randn(torch, shape, gen, dev).to(dt)
    return x, g, b, dy


def check_gpt2_kernels(torch, dev, gen):
    """The gpt2 family's kernels against their plain versions, fp32 and
    bf16: LayerNorm fwd and bwd, scaled masked softmax, bias_act, and flash
    attention at gpt2-xl's shape; bf16 max abs errors at the path shapes."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        bf = dtype_name == "bfloat16"
        # one warp per row at D 1600 (training rows, decode rows, a ragged
        # row count), then the block-per-row path (n no multiple of the
        # 16-byte vector; n past a warp's registers)
        for shape in ((GB * GS, GD), (GB, GD), (37, GD), (5, 100), (3, 4096)):
            x, g, b, dy = _ln_inputs(torch, dev, gen, dt, shape)
            y = ln.layer_norm_cuda(x, g, b, 1e-5)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, ln.layer_norm_plain(x, g, b, 1e-5),
                              TOL[dtype_name], f"layer_norm {dtype_name} {shape}")
            got = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            again = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"layer_norm_bwd {dtype_name} {shape}: two calls differ")
            want = ln.layer_norm_bwd_plain(x, g, dy, 1e-5)
            e_dx = _assert_close(torch, got[0], want[0], TOL[dtype_name],
                                 f"layer_norm_bwd dx {dtype_name} {shape}")
            rel = max(_rel_err(got[1], want[1]), _rel_err(got[2], want[2]))
            check(rel < GRAD_TOL[dtype_name], f"layer_norm_bwd dγ/dβ "
                  f"{dtype_name} {shape}: relative error {rel}")
            print(f"gpt2 kernels: layer_norm {dtype_name} {list(shape)}: y max "
                  f"abs err {e:.3g}; bwd dx {e_dx:.3g}, dγ/dβ relative "
                  f"{rel:.3g}, second call bit-equal")
            if bf and shape == (GB * GS, GD):
                errs["layer_norm"], errs["layer_norm_bwd"] = e, e_dx
            del x, dy, y, got, again, want
        # a causal [S, S] bool mask and a per-sequence [B, 1, n] int padding
        # mask, each read through its strides; n = 1000 is no power of two
        causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
        padding = torch.ones(3, 1, 1000, dtype=torch.int32, device=dev)
        padding[1, :, 640:] = 0
        for shape, mask in (((GSB, GH, GS, GS), None),
                            ((GSB, GH, GS, GS), causal),
                            ((3, 7, 1000), None), ((3, 7, 1000), padding)):
            x = _randn(torch, shape, gen, dev, 4).to(dt)
            y = sm.scaled_masked_softmax_triton(x, mask, GDH ** -0.5)
            torch.cuda.synchronize()
            want = sm.scaled_masked_softmax_plain(x, mask, GDH ** -0.5)
            what = (f"softmax {dtype_name} {list(shape)} "
                    f"{'masked' if mask is not None else 'no mask'}")
            e = _assert_close(torch, y, want, TOL[dtype_name], what)
            try:
                torch.testing.assert_close(y.float(), want.float(), atol=1e-6,
                                           rtol=SOFTMAX_RTOL[dtype_name])
            except AssertionError as err:
                raise RuntimeError(f"chip_smoke: {what}: relative check: "
                                   f"{err}") from None
            print(f"gpt2 kernels: {what}: max abs err {e:.3g}, each output "
                  f"within {SOFTMAX_RTOL[dtype_name]:g} relative")
            if bf and shape[-1] == GS:
                errs["scaled_masked_softmax"] = max(
                    errs.get("scaled_masked_softmax", 0.0), e)
            del x, y, want
        x = _randn(torch, (GB * GS, GF), gen, dev, 3).to(dt)
        b = _randn(torch, (GF,), gen, dev).to(dt)
        for act in ("gelu", "relu", "silu", "identity"):
            y = sm.bias_act_triton(x, b, act)
            torch.cuda.synchronize()
            e = _assert_close(torch, y, sm.bias_act_plain(x, b, act),
                              TOL[dtype_name], f"bias_act {act} {dtype_name}")
            print(f"gpt2 kernels: bias_act {act} {dtype_name} "
                  f"[{GB * GS}, {GF}]: max abs err {e:.3g}")
            if bf:
                errs["bias_act"] = max(errs.get("bias_act", 0.0), e)
        del x, y
        e_o, rel_o, e_g, rel = check_flash(torch, dev, gen, dtype_name,
                                           (GB, GH, GS, GDH))
        print(f"gpt2 kernels: flash {dtype_name} {[GB, GH, GS, GDH]}: o max abs "
              f"err {e_o:.3g}, relative (Frobenius) {rel_o:.3g}; dq/dk/dv max "
              f"abs err {e_g:.3g}, max relative (Frobenius) {rel:.3g}")
        torch.cuda.empty_cache()
    # Adam on gpt2-xl's small leaves: the final norm's [1600] vector and a
    # stacked [48, 1600] norm leaf (fp32 masters and accumulator), three
    # steps against the plain update
    from deepspeed_tpu_torch.ops.kernels import fused_adam as adam

    for shape in ((GD,), (48, GD)):
        p = _randn(torch, shape, gen, dev)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        ref = [p.clone(), m.clone(), v.clone()]
        for step in (1, 2, 3):
            gr = _randn(torch, shape, gen, dev, 1e-3)
            kw = dict(lr=3e-4 * step, beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.1, adam_w_mode=True)
            adam.fused_adam_update_cuda(p, gr, m, v, step, **kw)
            adam.fused_adam_update_plain(ref[0], gr, ref[1], ref[2], step, **kw)
        torch.cuda.synchronize()
        e = max(_assert_close(torch, got, want, ADAM_TOL,
                              f"fused_adam {what} {list(shape)}")
                for got, want, what in zip((p, m, v), ref, ("p", "m", "v")))
        print(f"gpt2 kernels: fused_adam fp32 {list(shape)} x 3 steps: p/m/v "
              f"max abs err {e:.3g}")
        errs["fused_adam_gpt2"] = max(errs.get("fused_adam_gpt2", 0.0), e)
    return errs


def time_gpt2_kernels(torch, dev, gen, errs):
    """bf16 at gpt2-xl's shapes, beside the plain version, the PyTorch
    library call of the same function, and the bound from bytes."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    bf = torch.bfloat16
    out = {}
    x, g, b, dy = _ln_inputs(torch, dev, gen, bf, (GB * GS, GD))
    b_ms, b_by = bound_ms((2 * x.numel() + 2 * GD) * 2, 8 * x.numel())
    out["layer_norm"] = {
        "shape": "x [8192,1600] bf16",
        "ms": time_ms(torch, lambda: ln.layer_norm_cuda(x, g, b, 1e-5)),
        "plain_ms": time_ms(torch, lambda: ln.layer_norm_plain(x, g, b, 1e-5),
                            samples=10),
        "library_ms": time_ms(torch, lambda: F_.layer_norm(x, (GD,), g, b, 1e-5)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["layer_norm"]}
    xs = x[:GB].contiguous()
    out["layer_norm"]["decode_rows_ms"] = time_ms(
        torch, lambda: ln.layer_norm_cuda(xs, g, b, 1e-5))
    lib = [t.detach().clone().requires_grad_() for t in (x, g, b)]
    lib_y = F_.layer_norm(lib[0], (GD,), lib[1], lib[2], 1e-5)
    b_ms, b_by = bound_ms((3 * x.numel() + 3 * GD) * 2, 14 * x.numel())
    out["layer_norm_bwd"] = {
        "shape": "x, dy [8192,1600] bf16 (two launches)",
        "ms": time_ms(torch, lambda: ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)),
        "plain_ms": time_ms(torch, lambda: ln.layer_norm_bwd_plain(x, g, dy, 1e-5),
                            samples=10),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_y, lib, dy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["layer_norm_bwd"]}
    del x, dy, xs, lib, lib_y

    # softmax: scale 1 so that torch.softmax computes the same function
    x = _randn(torch, (GSB, GH, GS, GS), gen, dev, 0.5).to(bf)
    causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
    b_ms, b_by = bound_ms(2 * x.numel() * 2, 5 * x.numel())
    bm_ms, _ = bound_ms(2 * x.numel() * 2 + causal.numel(), 5 * x.numel())
    out["scaled_masked_softmax"] = {
        "shape": "x [4,25,1024,1024] bf16, no mask (masked: a causal "
                 "[1024,1024] bool mask)",
        "ms": time_ms(torch, lambda: sm.scaled_masked_softmax_triton(x),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: sm.scaled_masked_softmax_plain(x),
                            samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: torch.softmax(x, -1), samples=20,
                              inner=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "masked_ms": time_ms(torch, lambda: sm.scaled_masked_softmax_triton(
            x, causal), samples=20, inner=10),
        "masked_plain_ms": time_ms(
            torch, lambda: sm.scaled_masked_softmax_plain(x, causal),
            samples=5, inner=3, warmup=2),
        "masked_bound_ms": bm_ms,
        "max_abs_err": errs["scaled_masked_softmax"]}
    del x

    x = _randn(torch, (GB * GS, GF), gen, dev, 3).to(bf)
    b = _randn(torch, (GF,), gen, dev).to(bf)
    b_ms, b_by = bound_ms((2 * x.numel() + GF) * 2, 12 * x.numel())
    out["bias_act"] = {
        "shape": "x [8192,6400] bf16, gelu",
        "ms": time_ms(torch, lambda: sm.bias_act_triton(x, b, "gelu"),
                      samples=20, inner=10),
        "plain_ms": time_ms(torch, lambda: sm.bias_act_plain(x, b, "gelu"),
                            samples=5, inner=3, warmup=2),
        "library_ms": time_ms(torch, lambda: F_.gelu(x + b, approximate="tanh"),
                              samples=20, inner=10),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["bias_act"]}
    del x
    torch.cuda.empty_cache()
    return out


def time_flash_gpt2_shape(torch, dev, gen):
    """Flash attention fwd and bwd at gpt2-xl's shape, bf16, beside SDPA and
    the bound (the kernels' own table rows are timed at llama-1b4's)."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    bf = torch.bfloat16
    q, k, v, do = (_randn(torch, (GB, GH, GS, GDH), gen, dev).to(bf)
                   for _ in range(4))
    scale = GDH ** -0.5
    fwd_flops = 4 * (GB * GH * GS * (GS + 1) // 2) * GDH
    o, lse = fa.flash_fwd_cuda(q, k, v, True, scale)
    lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib, is_causal=True)
    out = {
        "shape": "q, k, v [8,25,1024,64] bf16, causal",
        "fwd_ms": time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale),
                          samples=20, inner=10),
        "fwd_library_ms": time_ms(
            torch, lambda: F_.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            samples=20, inner=10),
        "fwd_bound_ms": bound_ms(4 * q.numel() * 2 + GB * GH * GS * 4,
                                 fwd_flops, BF16_FLOPS_PER_S)[0],
        "bwd_ms": time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, True, scale), samples=20, inner=5),
        "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib, do, retain_graph=True), samples=20, inner=5),
        "bwd_bound_ms": bound_ms(8 * q.numel() * 2 + GB * GH * GS * 4,
                                 2.5 * fwd_flops, BF16_FLOPS_PER_S)[0]}
    del q, k, v, do, o, lse, lib, lib_out
    torch.cuda.empty_cache()
    return out


def time_head_gemms(torch, dev, gen):
    """What gpt2's odd vocabulary costs: the three GEMMs of one 2048-row
    chunk of the tied head and blockwise CE (logits = x @ tok^T, dx =
    dlogits @ tok, dtok = dlogits^T @ x) in bf16 at V = 50257, whose
    [rows, V] operands have an unaligned leading dimension, beside the same
    at V = 50304 (a multiple of 64, llama-1b4's).  The port does not pad:
    the width is the model's."""
    bf = torch.bfloat16
    x = _randn(torch, (2048, GD), gen, dev).to(bf)
    out = {}
    for V in (50257, 50304):
        tok = _randn(torch, (V, GD), gen, dev, 0.02).to(bf)
        dl = _randn(torch, (2048, V), gen, dev).to(bf)
        out[V] = (time_ms(torch, lambda: x @ tok.t(), samples=10, inner=5),
                  time_ms(torch, lambda: dl @ tok, samples=10, inner=5),
                  time_ms(torch, lambda: dl.t() @ x, samples=10, inner=5))
        del tok, dl
    # a step: gas 2 x 4 chunks, the logits computed in the forward and again
    # in the backward (the chunk is checkpointed)
    per_step = {V: 8 * (2 * f + d + w) for V, (f, d, w) in out.items()}
    print("head GEMMs, one [2048, 1600] chunk against the tied [V, 1600] "
          "embedding, bf16: " + "; ".join(
              f"V={V}: logits {f:.3f} ms, dx {d:.3f} ms, dtok {w:.3f} ms "
              f"({per_step[V]:.1f} ms a 16384-token step)"
              for V, (f, d, w) in out.items())
          + f"; the odd width costs {per_step[50257] - per_step[50304]:.1f} ms "
            f"a step")
    torch.cuda.empty_cache()


def phase_kernels(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = check_old_kernels(torch, dev, gen)
    print(f"kernels vs plain: fp32 within 1e-5, bf16 within 2e-2; bf16 max "
          f"abs err rms_norm {errs['rms_norm']:.3g}, rope {errs['rope']:.3g}")
    errs.update(check_decode_kernels(torch, dev, gen, "llama3-8b"))
    gpt2_decode = check_decode_kernels(torch, dev, gen, "gpt2-xl")
    errs.update(check_train_kernels(torch, dev, gen))
    errs.update(check_gpt2_kernels(torch, dev, gen))
    errs.update(check_optimizer_kernels(torch, dev, gen))
    out = time_old_kernels(torch, dev, gen, errs)
    out.update(time_decode_kernels(torch, dev, gen, errs))
    out.update(time_train_kernels(torch, dev, gen, errs))
    out.update(time_gpt2_kernels(torch, dev, gen, errs))
    out.update(time_optimizer_kernels(torch, dev, gen, errs))
    out["rms_norm"]["max_abs_err_train_shape"] = errs["rms_norm_train"]
    out["rope"]["max_abs_err_train_shape"] = errs["rope_train"]
    for name, e in gpt2_decode.items():
        out[name]["max_abs_err_gpt2_shape"] = e
    out["fused_adam"]["max_abs_err_gpt2_shape"] = errs["fused_adam_gpt2"]
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        mm = (f", torch.matmul yardstick {r['matmul_ms']:.5f} ms"
              if "matmul_ms" in r else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib} ms{mm}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    gpt2_flash = time_flash_gpt2_shape(torch, dev, gen)
    out["flash_attention_fwd"]["gpt2_shape"] = gpt2_flash
    out["flash_attention_bwd"]["gpt2_shape"] = gpt2_flash
    print("time flash attention {shape}: fwd kernel {fwd_ms:.5f} ms, SDPA "
          "{fwd_library_ms:.5f} ms, bound {fwd_bound_ms:.6f} ms; bwd kernel "
          "{bwd_ms:.5f} ms, SDPA bwd {bwd_library_ms:.5f} ms, bound "
          "{bwd_bound_ms:.6f} ms".format(**gpt2_flash))
    time_head_gemms(torch, dev, gen)
    return out


# small fp32 models of the two families for the card-against-CPU phases
SMALL = {
    "llama-tiny": dict(num_layers=2, hidden_size=256, intermediate_size=512,
                       num_heads=8, num_kv_heads=2, vocab_size=1024),
    # learned positions, LayerNorm, GeLU, a plain MLP, heads of 64
    "gpt2-small": dict(num_layers=2, hidden_size=256, intermediate_size=1024,
                       num_heads=4, vocab_size=1024, max_seq_len=512)}


def phase_reference(torch, dev, preset):
    """The port on the card against the port on the CPU, small fp32 model,
    on the default fused decode path and on the unfused one."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 matmuls
    model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", **SMALL[preset])
    with torch.no_grad():
        # spread logits away from ties; through gpt2's tied head a wide token
        # embedding alone makes each step repeat its input, so the position
        # table is widened further
        if model.config.position == "learned":
            model.embed.tok.mul_(16.0)
            model.embed.pos.mul_(80.0)
        else:
            model.embed.tok.mul_(40.0)
    prompts = [np.random.default_rng(i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    for fused in (True, False):
        cfg = {"dtype": "float32", "max_out_tokens": 512,
               "kv_page_tokens": 64}
        if not fused:
            cfg["use_fused_decode"] = False
        outs = []
        for d in ("cpu", dev):
            serve = deepspeed_tpu_torch.init_serving(
                model, cfg, device=d, num_slots=2, prefill_chunk=32)
            check((serve.engine._dparams is not None) is fused,
                  f"fused={fused}: wrong decode path")
            reqs = [serve.submit(p, max_new_tokens=16) for p in prompts]
            serve.run()
            serve.pool.check_no_leak()
            outs.append([r.output_tokens for r in reqs])
        check(outs[0] == outs[1], f"fused={fused}: card vs CPU tokens "
              f"differ: {outs}")
        print(f"reference: small fp32 {preset} model, "
              f"{'fused' if fused else 'unfused'} decode, card == CPU on "
              f"{len(prompts)} requests x 16 tokens "
              f"({len({t for o in outs[0] for t in o})} distinct)")


KERNELS = ("rms_norm", "rope", "fused_norm_qkv", "flash_decode",
           "fused_proj_norm", "fused_mlp", "rms_norm_bwd",
           "flash_attention_fwd", "flash_attention_bwd", "fused_adam",
           "layer_norm", "layer_norm_bwd", "scaled_masked_softmax", "bias_act",
           "quantize", "fused_adam8bit", "fused_lamb_phase1", "fused_lamb_scale")


def launch_counters():
    from deepspeed_tpu_torch.ops.kernels import (apply_rotary_pos_emb, bias_act,
                                                 fused_adam8bit_update,
                                                 fused_adam_update, lamb_phase1,
                                                 lamb_scale, layer_norm_bwd,
                                                 quantize, rms_norm,
                                                 rms_norm_bwd,
                                                 scaled_masked_softmax)
    from deepspeed_tpu_torch.ops.kernels import decode as dk
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels.layer_norm import layer_norm

    return {"rms_norm": rms_norm, "rope": apply_rotary_pos_emb,
            "fused_norm_qkv": dk.fused_norm_qkv,
            "flash_decode": dk.flash_decode,
            "fused_proj_norm": dk.fused_proj_norm, "fused_mlp": dk.fused_mlp,
            "rms_norm_bwd": rms_norm_bwd,
            "flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_adam": fused_adam_update, "layer_norm": layer_norm,
            "layer_norm_bwd": layer_norm_bwd,
            "scaled_masked_softmax": scaled_masked_softmax,
            "bias_act": bias_act, "quantize": quantize,
            "fused_adam8bit": fused_adam8bit_update,
            "fused_lamb_phase1": lamb_phase1, "fused_lamb_scale": lamb_scale}


def zero_counts():
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def norm_kernel(cfg):
    return "layer_norm" if cfg.norm == "layernorm" else "rms_norm"


def launch_plan(cfg, chunks, steps, fused):
    """Launches a run must make: per prefill chunk 2L+1 norms (RMSNorm or
    LayerNorm, as the model has it) and, for a RoPE model, 2L RoPEs; per
    decode step either 4 fused calls per layer and the final norm (fused)
    or 2L+1 norms (unfused)."""
    L = cfg.num_layers
    plan = {k: 0 for k in KERNELS}
    if cfg.position == "rope":
        plan["rope"] = 2 * L * chunks
    if fused:
        plan[norm_kernel(cfg)] = (2 * L + 1) * chunks + steps
        for k in KERNELS[2:6]:
            plan[k] = L * steps
    else:
        plan[norm_kernel(cfg)] = (2 * L + 1) * (chunks + steps)
    return plan


def phase_ops(torch, dev):
    """The ops of the public kernel library that no model path calls,
    driven through the library's wrappers: at gpt2-xl's shapes (bf16) the
    scores of one layer over 4 sequences through ``scaled_masked_softmax``
    with a causal mask and the MLP's pre-activation through ``bias_act``;
    the [24, 2048, 5632] fp32 MLP leaf of llama-1b4 through ``quantize`` ->
    ``dequantize`` at 8 and 4 bits, the 4-bit codes through ``pack_int4``
    -> ``unpack_int4``.  The launch counts are read over these calls, and
    each result is held to the op's plain version (TOL, and SOFTMAX_RTOL on
    each probability; the quantizer's codes and scales equal), the round
    trip to half a code step."""
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.kernels import quantizer as kq
    from deepspeed_tpu_torch.ops.kernels import softmax as sm

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    scores = _randn(torch, (GSB, GH, GS, GS), gen, dev, 4).to(bf)
    causal = torch.ones(GS, GS, dtype=torch.bool, device=dev).tril()
    up = _randn(torch, (GB * GS, GF), gen, dev, 3).to(bf)
    b_up = _randn(torch, (GF,), gen, dev).to(bf)
    w = _randn(torch, (TL, TD, TF), gen, dev, 0.02)
    zero_counts()
    probs = K.scaled_masked_softmax(scores, causal, scale=GDH ** -0.5)
    a = K.bias_act(up, b_up, "gelu")
    quant = {}
    for bits in (8, 4):
        q, sc, pad = K.quantize(w, bits=bits)
        back = K.dequantize(q, sc, pad, w.shape)
        if bits == 4:
            packed = K.pack_int4(q)
            unpacked = K.unpack_int4(packed, q.numel()).view(q.shape)
        quant[bits] = (q, sc, pad, back)
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict({name: 0 for name in KERNELS}, scaled_masked_softmax=1,
                bias_act=1, quantize=2)
    check(launches == want, f"ops launches {launches} != {want}")
    for bits, (q, sc, pad, back) in quant.items():
        wq, ws, wpad = kq.quantize_plain(w, bits, 2048)
        check(pad == wpad and torch.equal(q, wq) and torch.equal(sc, ws),
              f"ops: quantize {bits} bits differs from its plain version")
        step = torch.repeat_interleave(sc, 2048)[: w.numel()].view(w.shape)
        # half a code, plus the fp32 rounding of q * scale (up to 127
        # codes x 2^-24 of a code step)
        err = float(((back - w).abs() / step).max())
        check(back.shape == w.shape and err <= 0.5 + 1e-4,
              f"ops: dequantize({bits} bits) is {err} code steps off")
        print(f"ops: quantize -> dequantize {bits} bits, fp32 "
              f"{list(w.shape)} at block 2048: codes and scales equal to the "
              f"plain version's, round trip within {err:.4f} of a code step")
    check(torch.equal(unpacked, quant[4][0]) and packed.numel() * 2 == w.numel(),
          "ops: unpack_int4(pack_int4(q)) != q")
    print(f"ops: pack_int4 -> unpack_int4 of the {w.numel()} 4-bit codes: "
          f"{packed.numel()} bytes, unpacked equal")
    del w, quant, back, packed, unpacked
    plain = sm.scaled_masked_softmax_plain(scores, causal, GDH ** -0.5)
    e_s = _assert_close(torch, probs, plain, TOL["bfloat16"], "ops: softmax")
    check(bool(torch.isclose(probs.float(), plain.float(), atol=1e-6,
                             rtol=SOFTMAX_RTOL["bfloat16"]).all()),
          "ops: softmax: a probability is off by more than one rounding")
    e_a = _assert_close(torch, a, sm.bias_act_plain(up, b_up, "gelu"),
                        TOL["bfloat16"], "ops: bias_act gelu")
    print(f"ops: scaled_masked_softmax [4, 25, 1024, 1024] (causal bool mask "
          f"read by strides) and bias_act gelu [8192, 6400] through the "
          f"library's wrappers: max abs err vs plain {e_s:.3g} / {e_a:.3g}; "
          f"launches softmax {launches['scaled_masked_softmax']}, bias_act "
          f"{launches['bias_act']}, quantize {launches['quantize']}")
    torch.cuda.empty_cache()
    return launches


def timed(torch, spent, name, fn):
    """Wrap an engine phase with synchronizes to attribute device time."""
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
    return wrapper


def phase_serve(torch, dev, preset):
    import gc

    import numpy as np

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm(preset, dtype=torch.bfloat16, seed=0)
    cfg = model.config
    L = cfg.num_layers
    # the default config: no use_fused_decode key, so the fused decode path
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "paged_kv_cache": True,
                       "prefix_caching": True, "max_out_tokens": 1024},
        num_slots=8, prefill_chunk=64)
    torch.cuda.synchronize()
    check(serve.engine._dparams is not None, "the default config did not "
          "build the kernel-injected view")
    print(f"serve: {preset} D={cfg.hidden_size} L={L} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size} "
          f"{cfg.norm}, {cfg.position} positions, bf16 random weights (seed 0), "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
          f"page {serve.pool.page} x {serve.pool.num_pages - 1}, fused "
          f"decode, built in {time.perf_counter() - t0:.1f}s")

    # phase timers: a synchronize around each prefill chunk and decode block
    # attributes device time to the phase (the smoke run trades the
    # engine's host/device overlap for this attribution)
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)

    rng = np.random.default_rng(0)
    lens = (17, 45, 64, 100, 128, 180, 256, 300)
    news = (32, 40, 48, 56, 64, 36, 44, 52)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    zero_counts()
    t0 = time.perf_counter()
    wave1 = [serve.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    serve.run()
    shared = np.concatenate([prompts[5][:128],
                             rng.integers(0, cfg.vocab_size, 60)])
    wave2 = [serve.submit(prompts[7], max_new_tokens=news[7]),
             serve.submit(shared, max_new_tokens=48)]
    serve.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    for req, n in zip(wave1 + wave2, news + (news[7], 48)):
        check(req.finish_reason == "length" and len(req.output_tokens) == n,
              f"request {req.request_id}: {req.finish_reason} with "
              f"{len(req.output_tokens)} tokens, want length/{n}")
        check(all(0 <= t < cfg.vocab_size for t in req.output_tokens),
              "token id out of range")
    hits = [r.prefix_hit_tokens for r in wave2]
    check(sum(hits) > 0, f"wave 2 missed the prefix cache: {hits}")
    check(wave2[0].output_tokens == wave1[7].output_tokens,
          "the exact repeat diverged from its cold run")
    serve.pool.check_no_leak()
    serve.prefix_cache.check_no_leak()
    st = serve.stats
    steps = st["decode_blocks"] * serve._K
    plan = launch_plan(cfg, st["prefill_chunks"], steps, fused=True)
    check(launches == plan, f"launches {launches} != path plan {plan}")
    check(all(launches[k] > 0 for k in (norm_kernel(cfg),) + KERNELS[2:6]),
          f"a serving kernel never ran: {launches}")
    print(f"serve: 10 requests in {wall:.2f}s; prefill {st['prefill_tokens']} "
          f"tokens in {st['prefill_chunks']} chunks, "
          f"{st['prefill_tokens'] / spent['prefill']:.1f} tok/s; decode "
          f"{st['decode_tokens']} tokens in {steps} steps of {serve.num_slots} "
          f"slots, {st['decode_tokens'] / spent['decode']:.1f} tok/s; "
          f"prefix hits wave 2 {hits}; launches {launches}")
    print(f"serve: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    first = {len(p): r.output_tokens[0] for p, r in zip(prompts, wave1)}
    del serve._prefill, serve._block       # drop the phase timers
    device_ms = phase_profile(torch, serve, prompts)
    serve.close()
    del serve
    phase_unfused(torch, model, prompts, first)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_ms


def phase_profile(torch, serve, prompts):
    """After the main path: one more 8-request wave under torch.profiler —
    device busy share of the wall clock, the kernels that take the device
    time, and each kernel's device time per launch (fused_mlp: per call of
    its two launches)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [p[:40] for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in reqs:
            serve.submit(p, max_new_tokens=24)
        serve.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"profile: fused decode, 8 x (40 prompt + 24 new) tokens, wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle "
          f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"profile: host self time {sum(e.self_cpu_time_total for e in host) / 1e3:.1f}"
          f" ms in profiled ops; top:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x {e.key[:60]}")
    out = {}
    tags = {"rms_norm": ("rms_norm_fwd_kernel",), "rope": ("_rope_fwd_kernel",),
            "layer_norm": ("layer_norm_fwd_",),
            "fused_norm_qkv": ("norm_qkv_kernel",),
            "flash_decode": ("flash_decode_paged_kernel",),
            "fused_proj_norm": ("proj_norm_kernel",),
            "fused_mlp": ("mlp_act_kernel", "mlp_down_kernel")}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        out[name] = None
        if not n:                       # not a kernel of this model's path
            continue
        total = sum(e.self_device_time_total for p in parts for e in p)
        out[name] = total / n / 1e3
        split = ""
        if len(parts) > 1 and n:
            split = " (" + " + ".join(
                f"{tag} {sum(e.self_device_time_total for e in p) / n / 1e3:.5f}"
                for tag, p in zip(keys, parts)) + ")"
        print(f"profile: {name} device time per launch {out[name]:.5f} ms over "
              f"{n} launches{split}")
    return out


# the train cells: preset -> (micro batch, sequence length); 16384 tokens a
# step each with gas 2
TRAIN_CELLS = {"llama-1b4": (4, 2048), "gpt2-xl": (8, 1024)}
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "FusedAdam", "params": {
        "lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_max_lr": 3e-4, "warmup_num_steps": 2}},
    "gradient_clipping": 1.0}
# config A, the memory rung: master-free bf16 (bf16 params and accumulator,
# Adam8bit's int8 moments and stochastic rounding); config B: FusedLamb over
# fp32 masters; each merged over TRAIN_CONFIG
ADAM8BIT_CONFIG = {"bf16": {"enabled": True, "master_weights": False},
                   "data_types": {"grad_accum_dtype": "bf16"},
                   "optimizer": dict(TRAIN_CONFIG["optimizer"], type="Adam8bit")}
LAMB_CONFIG = {"optimizer": dict(TRAIN_CONFIG["optimizer"], type="FusedLamb")}


def optimizer_plan(optimizer, steps):
    """Launches of the optimizer's kernels over ``steps`` steps: FusedAdam
    one a leaf, Adam8bit one a leaf of at least ``min_quant_size`` (the
    smaller keep fp32 moments and plain torch), FusedLamb one phase-1 call
    (phase 1 and the reduce) and one scale launch a leaf."""
    from deepspeed_tpu_torch.ops.adam import Adam8bit
    from deepspeed_tpu_torch.ops.lamb import FusedLamb

    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    if isinstance(optimizer, Adam8bit):
        return {"fused_adam8bit": steps * sum(map(optimizer.quantized, leaves))}
    if isinstance(optimizer, FusedLamb):
        return {"fused_lamb_phase1": steps * len(leaves),
                "fused_lamb_scale": steps * len(leaves)}
    return {"fused_adam": steps * len(leaves)}


def adam8bit_state_bytes(optimizer):
    """The state's bytes reckoned from the leaf shapes alone: two int8
    ``[nb_pad, block]`` code arrays and two fp32 ``[nb_pad, 1]`` scales a
    quantized leaf, two fp32 ``[n]`` moments a small one."""
    from deepspeed_tpu_torch.ops.kernels.fused_adam8bit import state_rows

    total = 0
    for g in optimizer.param_groups:
        for p in g["params"]:
            n = p.numel()
            if n >= optimizer.min_quant_size:
                rows = state_rows(n, optimizer.block)
                total += 2 * rows * optimizer.block + 2 * 4 * rows
            else:
                total += 2 * 4 * n
    return total


def train_plan(cfg, micros, steps, optimizer):
    """Launches a training run must make.  Per micro-batch: 2L+1 norm
    forwards (RMSNorm or LayerNorm) and as many backwards, L flash forward
    and L flash backward calls and, for a RoPE model, 2L RoPE forwards and
    2L backwards (the same kernel).  Remat adds forwards in the backward:
    the MLP policies recompute the MLP's norm (+L norm forwards), the
    whole-layer policies run the layer's forward again up to its last
    saved tensor (+2L norm forwards, +L flash forwards, +2L RoPEs).  The
    optimizer's launches as ``optimizer_plan`` counts them; no decode
    kernel."""
    L = cfg.num_layers
    mlp = bool(cfg.remat) and cfg.remat_policy in ("mlp_only", "mlp_dots")
    full = bool(cfg.remat) and not mlp
    rope = cfg.position == "rope"
    plan = {k: 0 for k in KERNELS}
    plan[norm_kernel(cfg)] = (2 * L + 1 + L * mlp + 2 * L * full) * micros
    plan[norm_kernel(cfg) + "_bwd"] = (2 * L + 1) * micros
    plan.update(rope=(4 * L + 2 * L * full) * micros * rope,
                flash_attention_fwd=(L + L * full) * micros,
                flash_attention_bwd=L * micros)
    plan.update(optimizer_plan(optimizer, steps))
    return plan


def phase_train_reference(torch, dev, preset, remat_policy):
    """A small fp32 model trained 3 steps on the card (kernels, TF32 off)
    and on the CPU (plain versions) from the same weights and tokens:
    per-step losses within rtol 1e-4 and final weights within atol 1e-4
    (fp32 sums in another order; Adam's normalised step keeps the weight
    difference near lr * 1e-4)."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(SMALL[preset], num_heads=4, remat=True,
                remat_policy=remat_policy)
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False},
               train_micro_batch_size_per_gpu=2)
    tok = np.random.default_rng(0).integers(0, 1024, (4, 200))   # ragged S
    runs = {}
    for d in ("cpu", dev):
        model = deepspeed_tpu_torch.causal_lm(preset, device="cpu", seed=0,
                                              **over)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device=d)
        losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
        runs[str(d)] = (losses, [p.cpu() for p in engine.master])
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    check(all(math.isfinite(x) for x in lg), f"card losses {lg}")
    for a, b in zip(lc, lg):
        check(abs(a - b) <= 1e-4 * abs(a), f"card vs CPU losses {lg} vs {lc}")
    diff = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(diff <= 1e-4, f"card vs CPU weights differ by {diff}")
    print(f"reference: small fp32 {preset} model (L 2, D 256, Dh 64, S 200, "
          f"remat {remat_policy}) trained 3 steps, card == CPU: losses {lg} vs "
          f"{lc}, weights max abs diff {diff:.3g}")


def phase_optimizer_reference(torch, dev):
    """The small llama-shaped model trained 3 steps on the card (kernels,
    TF32 off) and on the CPU (plain versions) from the same weights and
    tokens, once per new optimizer path:

    - FusedLamb over fp32 masters: losses within rtol 1e-4 and weights
      within atol 1e-4, as the FusedAdam reference;
    - Adam8bit over fp32 masters: losses within 1e-4; 99 % of the weights
      within 1e-4 and all within 1e-4 + lr / 16: where a gradient 1e-6
      apart moves a value across a .5 code boundary, that element's step
      moves by one code of m (1/127 of its row's absmax) over sqrt(v);
    - Adam8bit master-free bf16 (bf16 accumulator, stochastic rounding with
      the same noise on both): losses within 2e-2 relative and every
      floating leaf bf16 on both."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(SMALL["llama-tiny"], num_heads=4, remat=True,
                remat_policy="mlp_dots")
    lr = TRAIN_CONFIG["optimizer"]["params"]["lr"]
    cases = {
        "FusedLamb fp32": dict(optimizer=dict(TRAIN_CONFIG["optimizer"],
                                              type="FusedLamb"),
                               bf16={"enabled": False}),
        "Adam8bit fp32": dict(optimizer=dict(TRAIN_CONFIG["optimizer"],
                                             type="Adam8bit"),
                              bf16={"enabled": False}),
        "Adam8bit master-free bf16": ADAM8BIT_CONFIG}
    tok = np.random.default_rng(0).integers(0, 1024, (4, 200))
    for name, section in cases.items():
        cfg = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2, **section)
        runs = {}
        for d in ("cpu", dev):
            model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu",
                                                  seed=0, **over)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                        device=d)
            losses = [float(engine.train_step((tok, tok))) for _ in range(3)]
            runs[str(d)] = (losses, [p.cpu() for p in engine.master])
        (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
        check(all(math.isfinite(x) for x in lg), f"{name}: card losses {lg}")
        check(lg[-1] < lg[0] and lc[-1] < lc[0], f"{name}: losses did not fall "
              f"{lg} / {lc}")
        diffs = torch.cat([(a.float() - b.float()).abs().reshape(-1)
                           for a, b in zip(pc, pg)])
        if name.endswith("bf16"):
            for a, b in zip(lc, lg):
                check(abs(a - b) <= 2e-2 * abs(a), f"{name}: losses {lg} vs {lc}")
            check(all(p.dtype == torch.bfloat16 for p in pc + pg),
                  f"{name}: a master is not bf16")
        else:
            for a, b in zip(lc, lg):
                check(abs(a - b) <= 1e-4 * abs(a), f"{name}: losses {lg} vs {lc}")
            close = float((diffs <= 1e-4).float().mean())
            limit = 1e-4 if name.startswith("FusedLamb") else 1e-4 + lr / 16
            check(float(diffs.max()) <= limit and (
                name.startswith("FusedLamb") or close >= 0.99),
                f"{name}: weights differ by up to {float(diffs.max())} "
                f"({100 * close:.2f} % within 1e-4)")
        print(f"reference: small {name} (llama-tiny L 2, D 256, S 200) trained "
              f"3 steps, card vs CPU: losses {lg} vs {lc}, weights max abs "
              f"diff {float(diffs.max()):.3g}")


def phase_train(torch, dev, preset, name="train", section=None, peaks=None):
    """The training path at the preset's full width and depth, with
    TRAIN_CONFIG (FusedAdam over fp32 masters) or the optimizer ``section``
    merged over it; records its peak device memory in ``peaks[name]``."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.adam import Adam8bit

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm(preset, seed=0)
    cfg = model.config
    micro, S = TRAIN_CELLS[preset]
    L, gas = cfg.num_layers, 2
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(TRAIN_CONFIG, **(section or {}),
                                 train_micro_batch_size_per_gpu=micro))
    opt = engine.optimizer
    n_params = sum(p.numel() for p in engine.master)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (gas * micro, S), device=dev,
                           generator=gen)
    torch.cuda.synchronize()
    master = str(engine.master_dtype).replace("torch.", "")
    print(f"{name}: {preset} D={cfg.hidden_size} L={L} H={cfg.num_heads} "
          f"F={cfg.intermediate_size} V={cfg.vocab_size} tied, {cfg.norm}, "
          f"{cfg.position} positions, remat {cfg.remat_policy}; "
          f"{n_params / 1e9:.4f}B {master} params in "
          f"{len(engine.master)} leaves, {type(opt).__name__}, bf16 compute, "
          f"{str(engine.grad_accum_dtype).replace('torch.', '')} accumulator, "
          f"micro {micro} x gas {gas} x S {S}; built in "
          f"{time.perf_counter() - t0:.1f}s")
    if isinstance(opt, Adam8bit):
        check(all(p.dtype == engine.master_dtype for p in engine.master),
              f"{name}: a master is not {master}")
    zero_counts()
    steps = []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_step((tokens, tokens)))
        torch.cuda.synchronize()
        steps.append((loss, engine.get_global_grad_norm(), engine.get_lr()[0],
                      time.perf_counter() - t))
        print(f"{name}: step {i + 1} loss {steps[-1][0]:.5f} grad norm "
              f"{steps[-1][1]:.4f} next lr {steps[-1][2]:.3e} wall "
              f"{steps[-1][3]:.3f}s")
    launches = read_counts()
    check(all(math.isfinite(x[0]) and math.isfinite(x[1]) for x in steps),
          f"non-finite loss or grad norm: {steps}")
    check(steps[-1][0] < steps[0][0], f"loss did not fall: {steps}")
    plan = train_plan(cfg, gas * 5, 5, opt)
    check(launches == plan, f"{name} launches {launches} != path plan {plan}")
    if isinstance(opt, Adam8bit):
        held, want = opt.state_bytes(), adam8bit_state_bytes(opt)
        check(held == want, f"{name}: optimizer state {held} bytes, the leaf "
              f"shapes give {want}")
        print(f"{name}: optimizer state {held} bytes ({held / n_params:.4f} a "
              f"parameter: int8 codes, fp32 scales, the small leaves' fp32 "
              f"moments) = the count from the leaf shapes; every master "
              f"{master}")
    tokens_per_step = gas * micro * S
    steady = statistics.mean(x[3] for x in steps[1:])
    attn_flops = 6 * L * gas * micro * cfg.num_heads * S * S * cfg.head_dim
    flops = 6 * n_params * tokens_per_step + attn_flops
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if peaks is not None:
        peaks[name] = peak
    beside = (f" (FusedAdam phase: {peaks['train']:.2f} GiB)"
              if peaks and name != "train" and "train" in peaks else "")
    print(f"{name}: steady step (steps 2-5) {steady:.4f}s, "
          f"{tokens_per_step / steady:.1f} tokens/s, MFU "
          f"{100 * flops / steady / BF16_FLOPS_PER_S:.2f}% (6N + attention "
          f"{flops / 1e12:.1f} TFLOP per step over 989 TFLOP/s; recomputed "
          f"forwards not counted), peak device "
          f"memory {peak:.2f} GiB{beside}; launches {launches}")
    device_ms = phase_train_profile(torch, engine, tokens)
    del engine, model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_ms


def phase_train_profile(torch, engine, tokens):
    """One more train step under torch.profiler: device busy share, the top
    kernels, and each training kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_step((tokens, tokens))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the optimizer's record_function range also shows device time: it is a
    # span over the Adam kernels, not a kernel, so it is left out
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not e.key.startswith("Optimizer.")]
    busy = sum(e.self_device_time_total for e in kernels)
    micro, S = tokens.shape[0] // 2, tokens.shape[1]
    print(f"profile: one train step (gas 2 x micro {micro} x {S}), wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    # device time by kind of kernel: the library's GEMMs (the unaligned
    # head GEMM of an odd vocabulary apart), the port's kernels, PyTorch's
    # elementwise, reduction and copy kernels, whatever is left
    groups = {"GEMM (cuBLAS)": 0.0, "GEMM, unaligned (cutlass align1)": 0.0,
              "flash attention": 0.0, "norm fwd+bwd": 0.0, "rope": 0.0,
              "adam": 0.0, "adam8bit": 0.0, "lamb": 0.0,
              "PyTorch elementwise/reduce/copy": 0.0, "other": 0.0}
    for e in kernels:
        key = e.key
        if "align1" in key:
            g = "GEMM, unaligned (cutlass align1)"
        elif any(t in key for t in ("nvjet", "gemm", "cutlass", "cublas")):
            g = "GEMM (cuBLAS)"
        elif "flash_" in key:
            g = "flash attention"
        elif "norm_" in key or "rms_dg_reduce" in key:
            g = "norm fwd+bwd"
        elif "_rope_fwd_kernel" in key:
            g = "rope"
        elif "adam_kernel" in key:
            g = "adam"
        elif "adam8bit_kernel" in key:
            g = "adam8bit"
        elif "lamb_" in key:
            g = "lamb"
        elif "at::native" in key or "Memcpy" in key or "Memset" in key:
            g = "PyTorch elementwise/reduce/copy"
        else:
            g = "other"
        groups[g] += e.self_device_time_total
    print("profile: device time by kind: " + ", ".join(
        f"{g} {t / 1e3:.1f} ms ({100 * t / busy:.1f}%)"
        for g, t in groups.items() if t))
    tags = {"rms_norm": ("rms_norm_fwd_kernel",), "rope": ("_rope_fwd_kernel",),
            "rms_norm_bwd": ("rms_norm_bwd_kernel", "rms_dg_reduce_kernel"),
            "layer_norm": ("layer_norm_fwd_",),
            "layer_norm_bwd": ("layer_norm_bwd_kernel", "rms_dg_reduce_kernel"),
            "flash_attention_fwd": ("flash_fwd_kernel",),
            "flash_attention_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
            "fused_adam": ("adam_kernel",),
            "fused_adam8bit": ("adam8bit_kernel",),
            "fused_lamb_phase1": ("lamb_phase1_kernel", "lamb_reduce_kernel"),
            "fused_lamb_scale": ("lamb_scale_kernel",)}
    out = {}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        out[name] = None
        if not n:                       # not a kernel of this model's path
            continue
        total = sum(e.self_device_time_total for p in parts for e in p)
        out[name] = total / n / 1e3
        split = ""
        if len(parts) > 1 and n:
            split = " (" + " + ".join(
                f"{tag} {sum(e.self_device_time_total for e in p) / n / 1e3:.5f}"
                for tag, p in zip(keys, parts)) + ")"
        print(f"profile: {name} device time per call on the train path "
              f"{out[name]:.5f} ms over {n} calls{split}")
    return out


def phase_unfused(torch, model, prompts, first):
    """The unfused decode path on the same weights (no copy: the model's
    own tensors), a shorter wave with its own launch plan; each request's
    first token comes from the shared prefill and must match the fused
    run's."""
    import deepspeed_tpu_torch

    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "use_fused_decode": False,
                       "max_out_tokens": 1024},
        params=model.params(), num_slots=8, prefill_chunk=64)
    check(serve.engine._dparams is None, "use_fused_decode: False still "
          "built the kernel-injected view")
    spent = {"prefill": 0.0, "decode": 0.0}
    serve._prefill = timed(torch, spent, "prefill", serve._prefill)
    serve._block = timed(torch, spent, "decode", serve._block)
    picks = [p for p in prompts if len(p) in (17, 64, 100, 128)]
    zero_counts()
    reqs = [serve.submit(p, max_new_tokens=16) for p in picks]
    serve.run()
    torch.cuda.synchronize()
    launches = read_counts()
    for p, r in zip(picks, reqs):
        check(r.finish_reason == "length" and len(r.output_tokens) == 16,
              f"unfused request: {r.finish_reason} / {len(r.output_tokens)}")
        check(r.output_tokens[0] == first[len(p)], "unfused first token "
              "differs from the fused run's (same prefill)")
    serve.pool.check_no_leak()
    st = serve.stats
    steps = st["decode_blocks"] * serve._K
    plan = launch_plan(model.config, st["prefill_chunks"], steps, fused=False)
    check(launches == plan, f"unfused launches {launches} != plan {plan}")
    print(f"unfused: {len(reqs)} requests, decode {st['decode_tokens']} "
          f"tokens in {steps} steps, "
          f"{st['decode_tokens'] / spent['decode']:.1f} tok/s; prefill "
          f"{st['prefill_tokens'] / spent['prefill']:.1f} tok/s; launches "
          f"{launches}")
    serve.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build(torch, dev)
    timings = phase_kernels(torch, dev)
    for preset, policy in (("llama-tiny", "mlp_dots"), ("gpt2-small", "full")):
        phase_reference(torch, dev, preset)
        phase_train_reference(torch, dev, preset, policy)
    phase_optimizer_reference(torch, dev)
    # each path: (launch counts of its run, device ms per call in its profile)
    peaks = {}
    runs = {"ops": (phase_ops(torch, dev), {}),
            "serve": phase_serve(torch, dev, "llama3-8b"),
            "gpt2_serve": phase_serve(torch, dev, "gpt2-xl"),
            "train": phase_train(torch, dev, "llama-1b4", "train", peaks=peaks),
            "gpt2_train": phase_train(torch, dev, "gpt2-xl", "gpt2_train",
                                      peaks=peaks),
            "adam8bit_train": phase_train(torch, dev, "llama-1b4",
                                          "adam8bit_train", ADAM8BIT_CONFIG,
                                          peaks),
            "lamb_train": phase_train(torch, dev, "llama-1b4", "lamb_train",
                                      LAMB_CONFIG, peaks)}
    ident = gpu_identity()
    src = "deepspeed_tpu_torch/csrc/decode.cu"
    fa_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    ln_src = "deepspeed_tpu_torch/csrc/layer_norm.cu"
    sm_src = "deepspeed_tpu_torch/ops/kernels/softmax.py"
    lamb_src = "deepspeed_tpu_torch/csrc/fused_lamb.cu"
    pallas = "deepspeed_tpu/ops/pallas/"
    # name, route, source, the TPU kernel's file:line and function, and the
    # path whose run gives ``launches``
    table = [
        ("rms_norm", "cuda", ln_src, "layer_norm.py:200", "rms_norm", "serve"),
        ("rope", "triton", "deepspeed_tpu_torch/ops/kernels/rope.py",
         "rope.py:62", "_rope_fwd (and _rope_bwd_vjp, rope.py:89, through the "
         "same kernel)", "serve"),
        ("fused_norm_qkv", "cuda", src, "decode.py:123", "fused_norm_qkv", "serve"),
        ("flash_decode", "cuda", src, "decode.py:252", "_flash_decode_paged",
         "serve"),
        ("fused_proj_norm", "cuda", src, "decode.py:433", "fused_proj_norm",
         "serve"),
        ("fused_mlp", "cuda", src, "decode.py:546", "fused_mlp", "serve"),
        ("rms_norm_bwd", "cuda", ln_src, "layer_norm.py:228", "_rms_norm_bwd_vjp",
         "train"),
        ("flash_attention_fwd", "cuda", fa_src, "flash_attention.py:149",
         "_flash_fwd", "train"),
        ("flash_attention_bwd", "cuda", fa_src, "flash_attention.py:283",
         "_flash_bwd", "train"),
        ("fused_adam", "cuda", "deepspeed_tpu_torch/csrc/fused_adam.cu",
         "fused_adam.py:53", "fused_adam_update", "train"),
        ("layer_norm", "cuda", ln_src, "layer_norm.py:115", "layer_norm",
         "gpt2_serve"),
        ("layer_norm_bwd", "cuda", ln_src, "layer_norm.py:151",
         "_layer_norm_bwd_vjp", "gpt2_train"),
        ("scaled_masked_softmax", "triton", sm_src, "softmax.py:39",
         "scaled_masked_softmax (both pallas_call sites, :57 and :67)", "ops"),
        ("bias_act", "triton", sm_src, "softmax.py:92", "bias_act", "ops"),
        ("quantize", "cuda", "deepspeed_tpu_torch/csrc/quantizer.cu",
         "quantizer.py:36", "quantize", "ops"),
        ("fused_adam8bit", "cuda", "deepspeed_tpu_torch/csrc/fused_adam8bit.cu",
         "fused_adam8bit.py:64", "fused_adam8bit_update", "adam8bit_train"),
        ("fused_lamb_phase1", "cuda", lamb_src, "fused_lamb.py:68",
         "fused_lamb_update (_lamb_phase1_kernel, pallas_call :110, and the "
         "trust-ratio combine after it)", "lamb_train"),
        ("fused_lamb_scale", "cuda", lamb_src, "fused_lamb.py:68",
         "fused_lamb_update (_scale_kernel, pallas_call :128)", "lamb_train"),
    ]
    check([row[0] for row in table] == list(KERNELS), "kernel table out of step")
    kernels = []
    for name, route, source, where, fn_name, path in table:
        t = timings[name]
        launches, device_ms = runs[path]
        k = {"name": name, "route": route, "source": source,
             "replaces": pallas + where,
             "tpu_kernel": f"{pallas}{where.split(':')[0]}:{fn_name}",
             "launches": launches[name], "launches_on": path,
             "launches_by_path": {p: r[0][name] for p, r in runs.items()},
             "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"],
             "shape": t["shape"],
             "device_ms_by_path": {p: r[1][name] for p, r in runs.items()
                                   if r[1].get(name) is not None}}
        k["device_ms_on_path"] = k["device_ms_by_path"].get(path)
        for extra in ("matmul_ms", "max_abs_err_train_shape",
                      "max_abs_err_gpt2_shape", "decode_rows_ms",
                      "masked_ms", "masked_plain_ms", "masked_bound_ms",
                      "gpt2_shape", "fp32_masters", "whole_update_bound_ms"):
            if extra in t:
                k[extra] = t[extra]
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms",
                                                "max_abs_err")),
              f"{name}: a non-finite number")
        check(k["launches"] > 0, f"{name}: no launch on its path")
        kernels.append(k)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
