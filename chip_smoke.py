#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and triton; imports nothing of JAX.  Phases
(each one raises, and the script exits non-zero, on any failure):

1. build   — compile the CUDA RMSNorm library with nvcc (in a thread) while
             Triton compiles the RoPE kernel; print build seconds and the
             ptxas register / shared-memory lines;
2. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes, fp32 (rtol/atol 1e-5) and bf16 (2e-2: one bf16
             rounding of each output), then CUDA-event timings (median of
             50 samples of 20 launches) beside the plain version, the
             PyTorch library call where one exists, and the bound;
3. reference — a small fp32 model served on the card (kernels) and on the
             CPU (plain versions) must give the same greedy tokens;
4. serve   — the main path: ``init_serving(causal_lm("llama3-8b"), ...)``
             at full width and depth with random bf16 weights from seed 0,
             8 greedy requests, then a second wave with an exact repeat and a
             shared-prefix request; launch counters are zeroed just before
             and read just after, and must match the path's launch plan;
             then one more wave under torch.profiler (device busy share,
             top kernels, each ported kernel's device time per launch);
5. report  — the card's name and power limit, the kernels JSON line, and
             last the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build(torch, dev):
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import rope

    result = {}

    def cuda_build():
        t0 = time.perf_counter()
        try:
            result["lib"] = build.load_library("layer_norm")
        except Exception as e:          # re-raised on the main thread
            result["error"] = e
        result["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=cuda_build)
    th.start()
    t0 = time.perf_counter()
    x = torch.ones(1, 1, 8, 128, device=dev, dtype=torch.bfloat16)
    c = torch.ones(8, 64, device=dev, dtype=torch.bfloat16)
    rope.rope_triton(x, c, c)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    th.join()
    if "error" in result:
        raise result["error"]
    lib = result["lib"]
    print(f"build: nvcc {lib.path.name} {result['seconds']:.2f}s "
          f"(0.00 = reused), triton rope compile+first launch {triton_s:.2f}s")
    for line in lib.ptxas_info:
        print(f"  ptxas: {line}")
    return {"rms_norm": result["seconds"], "rope": triton_s}


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import layer_norm, rope

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    # path shapes (llama3-8b): RMSNorm rows = num_slots (decode) or the
    # prefill chunk; RoPE q [1, 32, cb, 128], k [1, 8, cb, 128], cos/sin
    # [cb, 64] cast to the activation dtype
    errs = {"rms_norm": 0.0, "rope": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for rows in (8, 64):
            x = torch.randn(rows, 4096, device=dev, generator=gen).mul_(3).to(dt)
            g = (1 + 0.1 * torch.randn(4096, device=dev, generator=gen)).to(dt)
            y = layer_norm.rms_norm_cuda(x, g, 1e-5)
            torch.cuda.synchronize()
            ref = layer_norm.rms_norm_plain(x, g, 1e-5)
            torch.testing.assert_close(y.float(), ref.float(),
                                       rtol=TOL[dtype_name],
                                       atol=TOL[dtype_name])
            if dtype_name == "bfloat16":
                errs["rms_norm"] = max(errs["rms_norm"], float(
                    (y.float() - ref.float()).abs().max()))
        for heads in (32, 8):
            x = torch.randn(1, heads, 64, 128, device=dev, generator=gen).to(dt)
            cos, sin = rope.rope_angles(torch.arange(64, device=dev), 128,
                                        theta=500000.0)
            cos, sin = cos.to(dt), sin.to(dt)
            y = rope.rope_triton(x, cos, sin)
            torch.cuda.synchronize()
            ref = rope.rope_plain(x, cos, sin)
            torch.testing.assert_close(y.float(), ref.float(),
                                       rtol=TOL[dtype_name],
                                       atol=TOL[dtype_name])
            if dtype_name == "bfloat16":
                errs["rope"] = max(errs["rope"], float(
                    (y.float() - ref.float()).abs().max()))
    print(f"kernels vs plain: fp32 within 1e-5, bf16 within 2e-2; bf16 max "
          f"abs err rms_norm {errs['rms_norm']:.3g}, rope {errs['rope']:.3g}")

    # timings at the decode shape of RMSNorm (2L+1 launches per decode
    # step) and the prefill-chunk shape of RoPE (q, cb = 64), bf16
    bf = torch.bfloat16
    x = torch.randn(8, 4096, device=dev, generator=gen).to(bf)
    g = torch.ones(4096, device=dev, dtype=bf)
    lib_ms = None
    if hasattr(F, "rms_norm"):
        lib_ms = time_ms(torch, lambda: F.rms_norm(x, (4096,), g, 1e-5))
    nbytes = 2 * x.numel() * 2 + g.numel() * 2
    b_ms, b_by = bound_ms(nbytes, 4 * x.numel())
    out["rms_norm"] = {
        "shape": "x[8,4096] bf16",
        "ms": time_ms(torch, lambda: layer_norm.rms_norm_cuda(x, g, 1e-5)),
        "plain_ms": time_ms(torch, lambda: layer_norm.rms_norm_plain(x, g, 1e-5)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rms_norm"]}
    q = torch.randn(1, 32, 64, 128, device=dev, generator=gen).to(bf)
    cos, sin = rope.rope_angles(torch.arange(64, device=dev), 128,
                                theta=500000.0)
    cos, sin = cos.to(bf), sin.to(bf)
    nbytes = 2 * q.numel() * 2 + 2 * cos.numel() * 2
    b_ms, b_by = bound_ms(nbytes, 3 * q.numel())
    out["rope"] = {
        "shape": "q[1,32,64,128] bf16",
        "ms": time_ms(torch, lambda: rope.rope_triton(q, cos, sin)),
        "plain_ms": time_ms(torch, lambda: rope.rope_plain(q, cos, sin)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": errs["rope"]}
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        print(f"time {name} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


def phase_reference(torch, dev):
    """The port on the card against the port on the CPU, small fp32 model."""
    import numpy as np

    import deepspeed_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 matmuls
    over = dict(num_layers=2, hidden_size=256, intermediate_size=512,
                num_heads=8, num_kv_heads=2, vocab_size=1024)
    model = deepspeed_tpu_torch.causal_lm("llama-tiny", device="cpu", **over)
    with torch.no_grad():
        model.embed.tok.mul_(40.0)       # spread logits away from ties
    cfg = {"dtype": "float32", "use_fused_decode": False,
           "max_out_tokens": 512, "kv_page_tokens": 64}
    prompts = [np.random.default_rng(i).integers(0, 1024, n)
               for i, n in enumerate((70, 9, 130))]
    outs = []
    for d in ("cpu", dev):
        serve = deepspeed_tpu_torch.init_serving(model, cfg, device=d,
                                                 num_slots=2, prefill_chunk=32)
        reqs = [serve.submit(p, max_new_tokens=16) for p in prompts]
        serve.run()
        serve.pool.check_no_leak()
        outs.append([r.output_tokens for r in reqs])
    check(outs[0] == outs[1], f"card vs CPU tokens differ: {outs}")
    print(f"reference: small fp32 model, card == CPU on {len(prompts)} "
          f"requests x 16 tokens")


def phase_serve(torch, dev):
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import apply_rotary_pos_emb, rms_norm

    t0 = time.perf_counter()
    model = deepspeed_tpu_torch.causal_lm("llama3-8b", dtype=torch.bfloat16,
                                          seed=0)
    cfg = model.config
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "use_fused_decode": False,
                       "paged_kv_cache": True, "prefix_caching": True,
                       "max_out_tokens": 1024},
        num_slots=8, prefill_chunk=64)
    torch.cuda.synchronize()
    print(f"serve: llama3-8b D={cfg.hidden_size} L={cfg.num_layers} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size} "
          f"theta={cfg.rope_theta:g}, bf16 random weights (seed 0), "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
          f"page {serve.pool.page} x {serve.pool.num_pages - 1}, built in "
          f"{time.perf_counter() - t0:.1f}s")

    # phase timers: a synchronize around each prefill chunk and decode block
    # attributes device time to the phase (the smoke run trades the
    # engine's host/device overlap for this attribution)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t
        return wrapper

    serve._prefill = timed("prefill", serve._prefill)
    serve._block = timed("decode", serve._block)

    rng = np.random.default_rng(0)
    lens = (17, 45, 64, 100, 128, 180, 256, 300)
    news = (32, 40, 48, 56, 64, 36, 44, 52)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    rms_norm.launches = 0
    apply_rotary_pos_emb.launches = 0
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
    launches = {"rms_norm": rms_norm.launches,
                "rope": apply_rotary_pos_emb.launches}

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
    L = cfg.num_layers
    steps = st["decode_blocks"] * serve._K
    plan = {"rms_norm": (2 * L + 1) * (st["prefill_chunks"] + steps),
            "rope": 2 * L * st["prefill_chunks"]}
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
    device_ms = phase_profile(torch, serve, prompts)
    serve.close()
    return launches, device_ms


def phase_profile(torch, serve, prompts):
    """After the main path: one more 8-request wave under torch.profiler —
    device busy share of the wall clock, the kernels that take the device
    time, and each ported kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    del serve._prefill, serve._block       # drop the phase timers
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
    print(f"profile: 8 x (40 prompt + 24 new) tokens, wall {wall_us / 1e3:.1f}"
          f" ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}")
    out = {}
    for name, tag in (("rms_norm", "rms_norm_fwd_kernel"),
                      ("rope", "_rope_fwd_kernel")):
        hits = [e for e in kernels if tag in e.key]
        n = sum(e.count for e in hits)
        out[name] = (sum(e.self_device_time_total for e in hits) / n / 1e3
                     if n else None)
        print(f"profile: {name} device time per launch "
              f"{'not measured' if out[name] is None else f'{out[name]:.5f} ms'}"
              f" over {n} launches")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build(torch, dev)
    timings = phase_kernels(torch, dev)
    phase_reference(torch, dev)
    launches, device_ms = phase_serve(torch, dev)
    ident = gpu_identity()
    kernels = [
        {"name": "rms_norm", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/layer_norm.cu",
         "replaces": "deepspeed_tpu/ops/pallas/layer_norm.py:200",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/layer_norm.py:rms_norm"},
        {"name": "rope", "route": "triton",
         "source": "deepspeed_tpu_torch/ops/kernels/rope.py",
         "replaces": "deepspeed_tpu/ops/pallas/rope.py:62",
         "tpu_kernel": "deepspeed_tpu/ops/pallas/rope.py:_rope_fwd"},
    ]
    for k in kernels:
        t = timings[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=t["max_abs_err"],
                 ms=t["ms"], kernel_ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=t["library_ms"], shape=t["shape"],
                 device_ms_on_path=device_ms[k["name"]])
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
