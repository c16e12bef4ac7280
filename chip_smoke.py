#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; imports nothing of JAX.  Phases
(each one raises, and the script exits non-zero, on any failure):

1. build   — compile the two CUDA libraries (RMSNorm; the four fused decode
             kernels), one nvcc each, started together, while Triton
             compiles the RoPE kernel; print build seconds and the ptxas
             register / shared-memory / spill lines;
2. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes, fp32 and bf16, with the tolerances of TOL below
             (the flash-decode kernel at depths 1..1024 across page
             boundaries, a shuffled page table, 256- and 16-token pages),
             then CUDA-event timings (median of 50 samples of 20 calls;
             the GEMV kernels cycle through enough weight copies to miss
             the 50 MB L2, as 32 layers do) beside the plain version, the
             PyTorch library call where one exists, ``torch.matmul`` of
             the same activations and weights as a yardstick for the three
             GEMV kernels, and the bound;
3. reference — a small fp32 model served on the card (kernels) and on the
             CPU (plain versions) must give the same greedy tokens, on the
             default fused decode path and on ``use_fused_decode: False``;
4. serve   — the main path: ``init_serving(causal_lm("llama3-8b"),
             {"dtype": "bfloat16", ...})`` with the default decode (fused)
             at full width and depth with random bf16 weights from seed 0,
             8 greedy requests, then a second wave with an exact repeat and
             a shared-prefix request; launch counters are zeroed just before
             and read just after, and must match the path's launch plan;
             then one more wave under torch.profiler (device busy share,
             top kernels, each kernel's device time per launch); then the
             unfused decode path on the same weights, a shorter wave with
             its own launch plan;
5. report  — the card's name and power limit, the kernels JSON line, and
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
    from deepspeed_tpu_torch.ops.kernels import rope

    results = {}

    def cuda_build(name):
        t0 = time.perf_counter()
        try:
            results[name] = build.load_library(name)
        except Exception as e:          # re-raised on the main thread
            results[name] = e
        results[name + "_s"] = time.perf_counter() - t0

    threads = [threading.Thread(target=cuda_build, args=(n,))
               for n in ("layer_norm", "decode")]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    x = torch.ones(1, 1, 8, 128, device=dev, dtype=torch.bfloat16)
    c = torch.ones(8, 64, device=dev, dtype=torch.bfloat16)
    rope.rope_triton(x, c, c)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    for th in threads:
        th.join()
    for name in ("layer_norm", "decode"):
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
            elif "Used" in ln and (name == "layer_norm" or "bfloat16" in entry):
                print(f"  ptxas: {entry[:70]}: {ln.split(':', 1)[1].strip()}")
        print(f"  ptxas: {n_entries} entry functions, {len(spilled)} spill"
              + "".join(f"\n  ptxas spill: {s}" for s in spilled))
    print(f"build: triton rope compile+first launch {triton_s:.2f}s")
    return {"rms_norm": results["layer_norm_s"], "decode": results["decode_s"],
            "rope": triton_s}


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


def decode_inputs(torch, dev, gen, dt, copies=1):
    """Activations and ``copies`` sets of one layer's weights at the
    llama3-8b decode shapes (weights scaled as the model's init)."""
    def w(shape, fan_in):
        return [(_randn(torch, shape, gen, dev, fan_in ** -0.5)).to(dt)
                for _ in range(copies)]
    return {
        "x": _randn(torch, (B, D), gen, dev, 2).to(dt),
        "scale": (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(dt),
        "wqkv": w((D, NQKV), D), "wo": w((H * DH, D), H * DH),
        "ctx": _randn(torch, (B, H * DH), gen, dev).to(dt),
        "resid": _randn(torch, (B, D), gen, dev, 2).to(dt),
        "h": _randn(torch, (B, D), gen, dev).to(dt),
        "wu": w((D, F), D), "wg": w((D, F), D), "wd": w((F, D), F),
    }


def paged_inputs(torch, dev, gen, dt, page, pos, layers=2):
    """A stacked [layers, P, Hkv, page, Dh] pool behind a shuffled page table
    with a 1024-token window per slot, q [B, H, Dh], and pos [B]."""
    import numpy as np

    maxp = 1024 // page
    P = B * maxp + 1
    k = _randn(torch, (layers, P, HKV, page, DH), gen, dev).to(dt)
    v = _randn(torch, (layers, P, HKV, page, DH), gen, dev).to(dt)
    perm = np.random.default_rng(page).permutation(B * maxp) + 1
    table = torch.from_numpy(perm.reshape(B, maxp)).to(dev)
    q = _randn(torch, (B, H, DH), gen, dev).to(dt)
    return q, k, v, torch.tensor(pos, device=dev), table


def check_decode_kernels(torch, dev, gen):
    """The four fused decode kernels against their plain versions at the
    path shapes, fp32 and bf16; returns the bf16 max abs errors."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        bf = dtype_name == "bfloat16"
        t = decode_inputs(torch, dev, gen, dt)
        wqkv, wo = t["wqkv"][0], t["wo"][0]
        wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
        out = {}
        y = dk.fused_norm_qkv_cuda(t["x"], t["scale"], None, wqkv,
                                   kind="rmsnorm", eps=1e-5)
        torch.cuda.synchronize()
        out["fused_norm_qkv"] = _assert_close(
            torch, y, dk._norm_qkv_ref(t["x"], t["scale"],
                                       torch.zeros_like(t["scale"]), wqkv,
                                       None, kind="rmsnorm", eps=1e-5),
            GEMV_TOL[dtype_name], f"fused_norm_qkv {dtype_name}")
        r, h = dk.fused_proj_norm_cuda(t["ctx"], t["resid"], wo, None,
                                       t["scale"], None, kind="rmsnorm",
                                       eps=1e-5, parallel=False)
        torch.cuda.synchronize()
        wr, wh = dk._proj_norm_ref(t["ctx"], t["resid"], wo, None, t["scale"],
                                   torch.zeros_like(t["scale"]),
                                   kind="rmsnorm", eps=1e-5, parallel=False)
        out["fused_proj_norm"] = max(
            _assert_close(torch, r, wr, GEMV_TOL[dtype_name],
                          f"fused_proj_norm r {dtype_name}"),
            _assert_close(torch, h, wh, GEMV_TOL[dtype_name],
                          f"fused_proj_norm h {dtype_name}"))
        y = dk.fused_mlp_cuda(t["h"], t["resid"], wu, wd, wg, act="silu")
        torch.cuda.synchronize()
        out["fused_mlp"] = _assert_close(
            torch, y, dk._mlp_ref(t["h"], t["resid"], wu, wg, wd, None, None,
                                  None, act="silu"),
            GEMV_TOL[dtype_name], f"fused_mlp {dtype_name}")
        del t, wqkv, wo, wu, wg, wd
        # depths 1..1024 (pos 0..1023) across page boundaries
        fd = 0.0
        for page in (256, 16):
            for alibi in (False, True):
                q, k, v, pos, table = paged_inputs(
                    torch, dev, gen, dt, page,
                    [0, 254, 255, 256, 299, 300, 1022, 1023])
                for layer in (0, 1):
                    y = dk.flash_decode_paged_cuda(
                        q, k, v, pos, table, scale=DH ** -0.5, layer=layer,
                        alibi=alibi)
                    torch.cuda.synchronize()
                    fd = max(fd, _assert_close(
                        torch, y, dk._flash_decode_paged_ref(
                            q, k, v, pos, table, scale=DH ** -0.5,
                            layer=layer, alibi=alibi),
                        ATTN_TOL[dtype_name],
                        f"flash_decode {dtype_name} page {page} "
                        f"alibi {alibi} layer {layer}"))
        out["flash_decode"] = fd
        if bf:
            errs = out
    print("decode kernels vs plain: fp32 GEMV within 1e-4, attention 2e-4, "
          "bf16 within 2e-2; bf16 max abs err " + ", ".join(
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


def phase_kernels(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = check_old_kernels(torch, dev, gen)
    print(f"kernels vs plain: fp32 within 1e-5, bf16 within 2e-2; bf16 max "
          f"abs err rms_norm {errs['rms_norm']:.3g}, rope {errs['rope']:.3g}")
    errs.update(check_decode_kernels(torch, dev, gen))
    out = time_old_kernels(torch, dev, gen, errs)
    out.update(time_decode_kernels(torch, dev, gen, errs))
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        mm = (f", torch.matmul yardstick {r['matmul_ms']:.5f} ms"
              if "matmul_ms" in r else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib} ms{mm}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


def phase_reference(torch, dev):
    """The port on the card against the port on the CPU, small fp32 model,
    on the default fused decode path and on the unfused one."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 matmuls
    over = dict(num_layers=2, hidden_size=256, intermediate_size=512,
                num_heads=8, num_kv_heads=2, vocab_size=1024)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)       # spread logits away from ties
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
        print(f"reference: small fp32 model, {'fused' if fused else 'unfused'}"
              f" decode, card == CPU on {len(prompts)} requests x 16 tokens")


KERNELS = ("rms_norm", "rope", "fused_norm_qkv", "flash_decode",
           "fused_proj_norm", "fused_mlp")


def launch_counters():
    from deepspeed_tpu_torch.ops.kernels import (apply_rotary_pos_emb,
                                                 rms_norm)
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    return {"rms_norm": rms_norm, "rope": apply_rotary_pos_emb,
            "fused_norm_qkv": dk.fused_norm_qkv,
            "flash_decode": dk.flash_decode,
            "fused_proj_norm": dk.fused_proj_norm, "fused_mlp": dk.fused_mlp}


def zero_counts():
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def launch_plan(L, chunks, steps, fused):
    """Launches a run must make: per prefill chunk 2L+1 RMSNorms and 2L
    RoPEs; per decode step either 4 fused calls per layer and the final
    RMSNorm (fused) or 2L+1 RMSNorms (unfused)."""
    plan = {"rope": 2 * L * chunks}
    if fused:
        plan["rms_norm"] = (2 * L + 1) * chunks + steps
        for k in KERNELS[2:]:
            plan[k] = L * steps
    else:
        plan["rms_norm"] = (2 * L + 1) * (chunks + steps)
        for k in KERNELS[2:]:
            plan[k] = 0
    return plan


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


def phase_serve(torch, dev):
    import numpy as np

    import deepspeed_tpu_torch

    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("llama3-8b", dtype=torch.bfloat16,
                                          seed=0)
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
    print(f"serve: llama3-8b D={cfg.hidden_size} L={L} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size} "
          f"theta={cfg.rope_theta:g}, bf16 random weights (seed 0), "
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
    plan = launch_plan(L, st["prefill_chunks"], steps, fused=True)
    check(launches == plan, f"launches {launches} != path plan {plan}")
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: "
          f"{launches}")
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
            "fused_norm_qkv": ("norm_qkv_kernel",),
            "flash_decode": ("flash_decode_paged_kernel",),
            "fused_proj_norm": ("proj_norm_kernel",),
            "fused_mlp": ("mlp_act_kernel", "mlp_down_kernel")}
    for name, keys in tags.items():
        parts = [[e for e in kernels if tag in e.key] for tag in keys]
        n = sum(e.count for e in parts[0])
        total = sum(e.self_device_time_total for p in parts for e in p)
        out[name] = total / n / 1e3 if n else None
        split = ""
        if len(parts) > 1 and n:
            split = " (" + " + ".join(
                f"{tag} {sum(e.self_device_time_total for e in p) / n / 1e3:.5f}"
                for tag, p in zip(keys, parts)) + ")"
        print(f"profile: {name} device time per launch "
              f"{'not measured' if out[name] is None else f'{out[name]:.5f} ms'}"
              f" over {n} launches{split}")
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
    plan = launch_plan(model.config.num_layers, st["prefill_chunks"], steps,
                       fused=False)
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
    phase_reference(torch, dev)
    launches, device_ms = phase_serve(torch, dev)
    ident = gpu_identity()
    src = "deepspeed_tpu_torch/csrc/decode.cu"
    kernels = [
        {"name": "rms_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/layer_norm.cu",
         "replaces": "deepspeed_tpu/ops/pallas/layer_norm.py:200",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/layer_norm.py:rms_norm"},
        {"name": "rope", "route": "triton",
         "source": "deepspeed_tpu_torch/ops/kernels/rope.py",
         "replaces": "deepspeed_tpu/ops/pallas/rope.py:62",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/rope.py:_rope_fwd"},
        {"name": "fused_norm_qkv", "route": "cuda", "source": src,
         "replaces": "deepspeed_tpu/ops/pallas/decode.py:123",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/decode.py:fused_norm_qkv"},
        {"name": "flash_decode", "route": "cuda", "source": src,
         "replaces": "deepspeed_tpu/ops/pallas/decode.py:252",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/decode.py:_flash_decode_paged"},
        {"name": "fused_proj_norm", "route": "cuda", "source": src,
         "replaces": "deepspeed_tpu/ops/pallas/decode.py:433",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/decode.py:fused_proj_norm"},
        {"name": "fused_mlp", "route": "cuda", "source": src,
         "replaces": "deepspeed_tpu/ops/pallas/decode.py:546",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/decode.py:fused_mlp"},
    ]
    for k in kernels:
        t = timings[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=t["max_abs_err"],
                 ms=t["ms"], kernel_ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=t["library_ms"], shape=t["shape"],
                 device_ms_on_path=device_ms[k["name"]])
        if "matmul_ms" in t:
            k["matmul_yardstick_ms"] = t["matmul_ms"]
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms",
                                                "max_abs_err")),
              f"{k['name']}: a non-finite number")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
