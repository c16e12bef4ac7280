#!/usr/bin/env python3
"""Time RoPE on the paths of one checkout, and the llama3-8b decode step
around it, on one CUDA card.

    python3 rope_probe.py [--tree DIR] [--label NAME] [--parts kernel,step]
                          [--out DIR]

- ``kernel``: the RoPE work a path does at each of chip_smoke's
  ``ROPE_SHAPES`` (bf16, head dim 128: the serve prefill's q + k [1, 64,
  32 + 8, 128], generate()'s prefill [8, 256, 32 + 8, 128], a decode step's
  QKV rows [8, 32 + 8, 128], llama-1b4's training q + k [4, 2048, 16 + 16,
  128] forward and backward), as the checkout's path does it: with the
  one-launch RoPE kernel (``rope_qk``, ``rope_qkv_rows``, its backward)
  where the checkout has it; else as the paths did before it, q and k made
  contiguous and rotated by the Triton kernel one at a time (the backward
  with a ``-sin`` tensor, then the copy autograd makes back through the
  transpose), and the decode rows by the chain of plain torch ops.  For
  each: the kernel launches a call and their device us under the profiler
  with the inputs cycled past the 50 MB L2 ("alone"), the device us a call
  replayed from a CUDA graph, the call under CUDA events and the host's us
  a call; for the Triton kernel also its call alone.
- ``step``: llama3-8b at full width and depth (random bf16 weights from
  seed 0), 8 rows: ``decode_step`` alone on a contiguous cache at one scalar
  position (generate()'s branch, 264 deep in a 512 cache) and on a paged
  pool at per-row positions (serving's branch, 256-token pages): host us a
  step (the loop's time before its synchronize), wall us a step, kernel
  launches and device us a step under the profiler, the device's busy
  share; then ``generate()`` and ``init_serving`` end to end, 64 and 16 new
  tokens, differenced: decode tok/s, wall ms, launches and device ms a
  step.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from another checkout (an
unpacked parent commit), so that two versions are compared on one card in
one call; this checkout's ``chip_smoke.py`` gives the timing helpers.  The
card's name and power limit are printed beside the numbers; the results
also go to ``<out>/<label>.json`` (``--out``, by default
``build/rope_probe``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def chip_smoke():
    """This checkout's chip_smoke.py as a module (never another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_call(torch, call, calls, sessions=3):
    """(device us a call, kernel launches a call, kernel names) of ``call``
    under torch.profiler: every kernel it launches, over ``calls`` calls;
    of ``sessions`` sessions the one with the most records (a session on
    the H100 now and then lacks some)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        n = sum(e.count for e in ev)
        if best is None or n > best[1]:
            best = (sum(e.self_device_time_total for e in ev), n,
                    sorted({e.key[:50] for e in ev}))
    return best[0] / calls, best[1] / calls, best[2]


def path_fn(torch, rope, form, b, s, h, hk, d, cos, sin):
    """The RoPE work of the checkout's path at one shape, as a callable on
    the inputs: the one-launch kernel's forms where the checkout has them,
    else what the paths ran before."""
    if hasattr(rope, "rope_qk"):
        if form == "qk":
            return lambda q, k: rope.rope_qk(q, k, cos, sin)
        if form == "rows":
            return lambda qkv: rope.rope_qkv_rows(qkv, cos, sin, h, hk, d)
        return lambda dq, dk: rope.rope_qk_cuda(dq, dk, cos, sin, backward=True)
    if form == "qk":        # transformer / prefill: contiguous, then 2 launches
        return lambda q, k: tuple(rope.apply_rotary_pos_emb(
            t.transpose(1, 2).contiguous(), cos, sin) for t in (q, k))
    if form == "rows":      # fused decode: the plain chain, then q.contiguous()
        half = d // 2
        c, sn = cos[:, None], sin[:, None]

        def rows(qkv):
            t = qkv[:, :(h + hk) * d].reshape(b, h + hk, d)
            x1, x2 = t[..., :half].float(), t[..., half:].float()
            qk = torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1).to(t.dtype)
            return qk[:, :h].contiguous(), qk[:, h:]
        return rows

    def bwd(dq, dk):        # -sin, the kernel, the copy back through the transpose
        neg = -sin
        return tuple(rope.rope_triton(g.contiguous(), cos, neg).transpose(1, 2)
                     .reshape(b, s, -1) for g in (dq, dk))
    return bwd


def kernel_part(torch, cs, dev):
    from deepspeed_tpu_torch.ops.kernels import rope

    out = {}
    bf = torch.bfloat16
    for name, b, s, h, hk, form in cs.ROPE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        d = cs.DH
        elems = b * s * (h + hk) * d
        copies = max(2, min(2048, -(-128 * 2 ** 20 // (elems * 2))))
        if form == "rows":
            cos, sin = rope.rope_angles(torch.arange(b, device=dev) * 37 + 100, d,
                                        theta=500000.0)
            xs = [(x,) for x in cs._randn(torch, (copies, b, (h + 2 * hk) * d), gen,
                                           dev).to(bf)]
        else:
            cos, sin = (t.to(bf) for t in rope.rope_angles(
                torch.arange(s, device=dev), d, theta=500000.0))
            if form == "qk":
                xs = [(q.view(b, s, h, d), k.view(b, s, hk, d)) for q, k in zip(
                    cs._randn(torch, (copies, b, s, h * d), gen, dev).to(bf),
                    cs._randn(torch, (copies, b, s, hk * d), gen, dev).to(bf))]
            else:
                xs = list(zip(cs._randn(torch, (copies, b, h, s, d), gen, dev).to(bf),
                              cs._randn(torch, (copies, b, hk, s, d), gen, dev).to(bf)))
        fn = path_fn(torch, rope, form, b, s, h, hk, d, cos, sin)
        nxt = cs.cycler(xs)
        calls = 200 if elems < 2 ** 22 else 50
        dev_us, launches, names = profile_call(torch, lambda: fn(*nxt()), calls)
        r = out[name] = {
            "shape": f"{form} [{b}, {s}, {h}+{hk}, {d}] bf16", "device_us": dev_us,
            "launches": launches, "kernels": names,
            "graph_us": cs.graph_us(torch, lambda: fn(*nxt())),
            "ms": cs.time_ms(torch, lambda: fn(*xs[0])),
            "host_us": cs.host_us(torch, lambda: fn(*xs[0]), calls=2000)}
        if hasattr(rope, "rope_triton") and form == "qk":
            qc = xs[0][0].transpose(1, 2).contiguous()
            r["triton_call_ms"] = cs.time_ms(torch, lambda: rope.rope_triton(qc, cos, sin))
            r["triton_host_us"] = cs.host_us(torch, lambda: rope.rope_triton(qc, cos, sin),
                                             calls=2000)
        print(f"kernel {name} {r['shape']}: {launches:.1f} launches a call, device "
              f"{dev_us:.3f} us alone, {r['graph_us']:.3f} from a graph, call "
              f"{r['ms']:.5f} ms, host {r['host_us']:.3f} us"
              + (f"; the Triton call alone {r['triton_call_ms']:.5f} ms, host "
                 f"{r['triton_host_us']:.3f} us" if "triton_host_us" in r else "")
              + f"; {names}", flush=True)
        del xs
    return out


def step_loop(torch, step, n=50):
    """(host us a step before the synchronize, wall us a step) over ``n``
    steps after 5 more."""
    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / n * 1e6, (time.perf_counter() - t0) / n * 1e6


def step_part(torch, cs, dev):
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.fused_decode import decode_step

    bf = torch.bfloat16
    model = deepspeed_tpu_torch.causal_lm("llama3-8b", dtype=bf, seed=0)
    cfg = model.config
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    eng = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16",
                                                     "max_out_tokens": 1024})
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, cfg.vocab_size, (8, 200)), max_new_tokens=2)
    dp = eng._dparams
    tok = torch.randint(0, cfg.vocab_size, (8, 1), device=dev)
    contig = {"k": torch.zeros(L, 8, Hkv, 512, Dh, device=dev, dtype=bf),
              "v": torch.zeros(L, 8, Hkv, 512, Dh, device=dev, dtype=bf)}
    pool = {"k": torch.zeros(L, 17, Hkv, 256, Dh, device=dev, dtype=bf),
            "v": torch.zeros(L, 17, Hkv, 256, Dh, device=dev, dtype=bf)}
    table = torch.arange(1, 17, device=dev).view(8, 2)
    pos = torch.arange(8, device=dev) * 7 + 240
    out = {}
    for name, step in (
            ("generate_step", lambda i: decode_step(cfg, dp, tok, contig, 264 + i)),
            ("serve_step", lambda i: decode_step(cfg, dp, tok, pool, pos,
                                                 page_table=table))):
        host, wall = step_loop(torch, step)
        dev_us, launches, _ = profile_call(torch, lambda: step(0), 20, sessions=2)
        r = out[name] = {"host_us": host, "wall_us": wall, "device_us": dev_us,
                         "launches": launches, "busy": dev_us / wall}
        print(f"step {name} (decode_step alone, llama3-8b, 8 rows): host "
              f"{host:.1f} us a step, wall {wall:.1f} us, {launches:.1f} launches, "
              f"device {dev_us:.1f} us, busy {100 * r['busy']:.1f} %", flush=True)
    del contig, pool

    def e2e(run):
        """(wall s, device us, kernel launches, decode steps) of run(16) and
        run(64), the second minus the first."""
        got = []
        for n in (16, 64):
            run(n)                                  # warm at this length
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = run(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dev_us, launches, _ = profile_call(torch, lambda: run(n), 1, sessions=2)
            got.append((wall, dev_us, launches, steps))
        return [b - a for a, b in zip(*got)]

    prompts = rng.integers(0, cfg.vocab_size, (8, 200))

    def gen(n):
        eng.generate(prompts, max_new_tokens=n)
        return n - 1                                # decode forwards
    runs = {"generate": e2e(gen)}
    del eng
    serve = deepspeed_tpu_torch.init_serving(
        model, config={"dtype": "bfloat16", "paged_kv_cache": True,
                       "prefix_caching": False, "max_out_tokens": 1024},
        num_slots=8, prefill_chunk=64)

    def wave(n):
        before = serve.stats["decode_blocks"]
        for p in rng.integers(0, cfg.vocab_size, (8, 64)):
            serve.submit(p, max_new_tokens=n)
        serve.run()
        return (serve.stats["decode_blocks"] - before) * serve._K
    runs["serve"] = e2e(wave)
    serve.close()
    for name, (wall, dev_us, launches, steps) in runs.items():
        r = out[name] = {"decode_tok_s": 8 * steps / wall, "wall_ms": wall / steps * 1e3,
                         "device_ms": dev_us / steps / 1e3, "launches": launches / steps,
                         "busy": dev_us / 1e6 / wall, "steps": steps}
        print(f"e2e {name} (llama3-8b, 8 rows, 64 new tokens less 16): decode "
              f"{r['decode_tok_s']:.1f} tok/s, {r['wall_ms']:.3f} ms a step, "
              f"{r['launches']:.1f} launches and {r['device_ms']:.3f} device ms a step, "
              f"busy {100 * r['busy']:.1f} %", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import deepspeed_tpu_torch from this checkout")
    ap.add_argument("--label", default=None)
    ap.add_argument("--parts", default="kernel,step")
    ap.add_argument("--out", default=str(ROOT / "build" / "rope_probe"),
                    help="directory for <label>.json")
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("rope_probe: needs a CUDA card")
    cs = chip_smoke()
    label = args.label or ("parent" if args.tree else "change")
    card = cs.gpu_identity()
    print(f"rope_probe {label}: {tree}; card {card}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": card, "tree": str(tree)}
    parts = args.parts.split(",")
    if "kernel" in parts:
        res["kernel"] = kernel_part(torch, cs, dev)
    if "step" in parts:
        res["step"] = step_part(torch, cs, dev)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"rope_probe {label}: ok", flush=True)


if __name__ == "__main__":
    main()
