#!/usr/bin/env python3
"""Time the tensor-core decode GEMVs of one checkout, their weight stream
alone under other tiles, rings and grids, and copies of ``csrc/decode.cu``
changed on purpose, on one CUDA card.

    python3 gemv16_probe.py [--tree DIR] [--stream] [--variants [A,B]] [--label NAME]

Every build is timed by ``chip_smoke.gemv16_times`` at the decode paths'
shapes (8 rows): the bf16 fused_norm_qkv and fused_proj_norm at llama3-8b
([4096, 6144], [4096, 4096], RMSNorm) and gpt2-xl ([1600, 4800],
[1600, 1600], LayerNorm and biases), fused_mlp at both (3 x 58.7M weights,
gated SiLU; 2 x 10.2M, tanh-GeLU and biases) and the int8 fused_norm_qkv and
fused_proj_norm at llama3-8b: the call under CUDA events, the kernels' device time a call under
the profiler and replayed from a CUDA graph (weights cycled past the L2; the
graph's keeps the MLP's PDL overlap, the profiler's per-kernel sum counts
the down kernel's wait) and the host's time a call.  Before it is timed, each
kernel is held against its plain version within 2e-2 at each shape.

``--stream`` builds ``gemv16_probe.cu`` (the core's weight stream with the
products taken out, under each of its configurations, and a plain 16-byte
read) and times, on bf16 weights of llama3-8b's [4096, 6144], 2 x [4096,
14336] and [14336, 4096] and gpt2-xl's [1600, 6400] and [6400, 1600]
(copies past the L2), the stream under each configuration with the TMA's
L2 promotion at 128 and 256 bytes, the plain read of the same bytes, and
cuBLAS's products of 8 rows (``torch.matmul``, timed only): device us a
call under the profiler and TB/s.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from another checkout (an
unpacked parent commit: its kernels and its wrappers, built in DIR/build),
so that two versions are compared on one card in one call.  ``--variants``
also builds the copies of ``csrc/decode.cu`` that VARIANTS below makes (each
edit must match the source once; all of them, or those named), all builds
started together, and times each the same way.  The card's name and power limit are printed beside the
numbers; the results also go to ``build/gemv16_probe/<label>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# name: (what it measures, [(text of csrc/decode.cu, its replacement)],
# and True where the edit breaks the results: timed, not checked)
VARIANTS = {
    "repeat": ("the shipped source again: the noise between builds", []),
    "no_pdl": ("the MLP's down launch without PDL: a plain launch after the act launch",
               [("pd, dev, s, kLaunchPdl);", "pd, dev, s, kLaunchPlain);")]),
    "act_128": ("the MLP's act launches on 128-column tiles (2 boxes a weight)",
                [("using MlpActCfg = G16Cfg<uint16_t, 2, 1, 64, 3, 3>;",
                  "using MlpActCfg = G16Cfg<uint16_t, 2, 2, 32, 3, 3>;"),
                 ("using MlpAct1Cfg = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;",
                  "using MlpAct1Cfg = G16Cfg<uint16_t, 1, 2, 64, 3, 3>;")]),
    "down_128": ("the MLP's down launch on 128-column tiles (2 boxes)",
                 [("using MlpDownCfg = G16Cfg<uint16_t, 1, 1, 128, 3, 3>;",
                   "using MlpDownCfg = G16Cfg<uint16_t, 1, 2, 64, 3, 3>;")]),
    "proj8_6": ("the int8 proj_norm with a 6-stage ring",
                [("using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;",
                  "using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 6, 1>;")]),
    "proj8_3": ("the int8 proj_norm with a 3-stage ring",
                [("using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;",
                  "using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 1>;")]),
    "proj8_2bps": ("the int8 proj_norm with 2 blocks an SM, 4-stage rings",
                   [("using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;",
                     "using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 2>;")]),
    "proj8_9": ("the int8 proj_norm with a 9-stage ring",
                [("using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;",
                  "using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 9, 1>;")]),
    "proj8_64": ("the int8 proj_norm on 64-row stages, 12 a ring",
                 [("using Proj8Cfg = G16Cfg<int8_t, 1, 1, 128, 4, 1>;",
                   "using Proj8Cfg = G16Cfg<int8_t, 1, 1, 64, 12, 1>;")]),
    "qkv8_2bps": ("the int8 norm_qkv with 2 blocks an SM and 5-stage rings",
                  [("using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 3>;",
                    "using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 5, 2>;")]),
    "qkv8_64": ("the int8 norm_qkv on 64-row stages, 6 a ring",
                [("using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 3>;",
                  "using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 64, 6, 3>;")]),
    "qkv8_96": ("the int8 norm_qkv on 96-row stages, 4 a ring",
                [("using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 3>;",
                  "using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 96, 4, 3>;")]),
    "qkv8_256": ("the int8 norm_qkv on 256-column tiles (2 boxes), 64-row stages",
                 [("using Qkv8Cfg = G16Cfg<int8_t, 1, 1, 128, 3, 3>;",
                   "using Qkv8Cfg = G16Cfg<int8_t, 1, 2, 64, 3, 3>;")]),
    "stats16": ("norm_qkv's row statistics with 16 loads a lane in flight, not 8",
                [("#pragma unroll 8\n      for (int i = lane; i < nv; i += 32) {",
                  "#pragma unroll 16\n      for (int i = lane; i < nv; i += 32) {"),
                 ("#pragma unroll 8\n    for (int i = lane; i < nv; i += 32) {",
                  "#pragma unroll 16\n    for (int i = lane; i < nv; i += 32) {")]),
    "no_stats": ("norm_qkv's row statistics from 32 vectors of x, not the "
                 "whole row: what reading x in every block costs",
                 [("    const int nv = a.K / P::N;\n",
                   "    const int nv = min(a.K / P::N, 32);\n")], True),
}
# the weight stream's shapes: (name, K, N, weights a stage)
STREAM_SHAPES = (("llama3-8b qkv [4096,6144]", 4096, 6144, 1),
                 ("llama3-8b up+gate 2x[4096,14336]", 4096, 14336, 2),
                 ("llama3-8b down [14336,4096]", 14336, 4096, 1),
                 ("gpt2-xl up [1600,6400]", 1600, 6400, 1),
                 ("gpt2-xl down [6400,1600]", 6400, 1600, 1))


def chip_smoke():
    """This checkout's chip_smoke.py as a module (never another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(torch, cs, dev, gen):
    """Each kernel against its plain version at the path shapes, bf16."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    for model in ("llama3-8b", "gpt2-xl"):
        t = cs.decode_inputs(torch, dev, gen, bf, model=model)
        m = cs.DECODE_MODELS[model]
        kind = m["kind"]
        nb = t["nbias"] if t["nbias"] is not None else torch.zeros_like(t["scale"])
        w, wo = t["wqkv"][0], t["wo"][0]
        cs._assert_close(torch, dk.fused_norm_qkv_cuda(
            t["x"], t["scale"], t["nbias"], w, kind=kind, eps=1e-5),
            dk._norm_qkv_ref(t["x"], t["scale"], nb, w, None, kind=kind, eps=1e-5),
            2e-2, f"norm_qkv {model}")
        got = dk.fused_proj_norm_cuda(t["ctx"], t["resid"], wo, None, t["scale"],
                                      t["nbias"], kind=kind, eps=1e-5, parallel=False)
        want = dk._proj_norm_ref(t["ctx"], t["resid"], wo, None, t["scale"], nb,
                                 kind=kind, eps=1e-5, parallel=False)
        for i in range(2):
            cs._assert_close(torch, got[i], want[i], 2e-2, f"proj_norm {model} {'rh'[i]}")
        wu, wg, wd = t["wu"][0], t["wg"][0], t["wd"][0]
        cs._assert_close(torch, dk.fused_mlp_cuda(t["h"], t["resid"], wu, wd, wg,
                                                  act=m["act"]),
                         dk._mlp_ref(t["h"], t["resid"], wu, wg, wd, None, None, None,
                                     act=m["act"]), 2e-2, f"mlp {model}")
        del t
    x = cs._randn(torch, (cs.B, cs.D), gen, dev, 2).to(bf)
    s = (1 + 0.1 * torch.randn(cs.D, device=dev, generator=gen)).to(bf)
    w, ws = cs._int8_weight(torch, (cs.D, cs.NQKV), gen, dev)
    cs._assert_close(torch, dk.fused_norm_qkv_int8_cuda(x, s, None, w, ws, kind="rmsnorm",
                                                        eps=1e-5),
                     dk._norm_qkv_ref(x, s, torch.zeros_like(s), w, None, kind="rmsnorm",
                                      eps=1e-5, wscale=ws), 2e-2, "norm_qkv int8 llama3-8b")
    ctx = cs._randn(torch, (cs.B, cs.H * cs.DH), gen, dev).to(bf)
    resid = cs._randn(torch, (cs.B, cs.D), gen, dev, 2).to(bf)
    wo, wos = cs._int8_weight(torch, (cs.H * cs.DH, cs.D), gen, dev)
    got = dk.fused_proj_norm_int8_cuda(ctx, resid, wo, wos, None, s, None, kind="rmsnorm",
                                       eps=1e-5, parallel=False)
    want = dk._proj_norm_ref(ctx, resid, wo, None, s, torch.zeros_like(s), kind="rmsnorm",
                             eps=1e-5, parallel=False, wscale=wos)
    for i in range(2):
        cs._assert_close(torch, got[i], want[i], 2e-2, f"proj_norm int8 llama3-8b {'rh'[i]}")


def nvcc(src: Path, lib: Path, extra=()):
    """Start nvcc on ``src`` with the package's flags; returns the process."""
    from deepspeed_tpu_torch.ops.kernels import build

    return subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def start_variants(names, outdir):
    """Start nvcc on each variant's copy of csrc/decode.cu; returns {name:
    (its library's path, the process)}."""
    from deepspeed_tpu_torch.ops.kernels import build

    src = (build.CSRC / "decode.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is in csrc/decode.cu "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        cu = outdir / f"decode_{name}.cu"
        cu.write_text(text)
        lib = outdir / f"libdecode_{name}.so"
        procs[name] = (lib, nvcc(cu, lib))
    return procs


def finish(procs):
    for name, (lib, p) in procs.items():
        so, se = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{so}\n{se}")
    return {name: lib for name, (lib, _) in procs.items()}


def use_library(path):
    """Make the decode wrappers call the library at ``path``."""
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    lib = ctypes.CDLL(str(path))
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    build._LIBS["decode"] = build.BuiltLibrary("decode", Path(path), lib, [])
    build._BOUND.clear()
    dk._G16_WORKSPACE.clear()
    for cache in ("_MLP_WORKSPACE", "_Q8_WORKSPACE"):
        getattr(dk, cache, {}).clear()


def device_us(torch, call, calls=20):
    """Device us a call of every kernel ``call`` launches, under the
    profiler (the mean of ``calls`` calls after three)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0)
    return total / calls


def stream_sweep(torch, cs, lib, dev):
    """The weight stream alone (every configuration, L2 promotion 128 and 256
    bytes), a plain read of the same bytes and cuBLAS's products, at each
    STREAM_SHAPES shape: {shape: {what: {"us", "tbps"}}}."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_stream.argtypes = [I, P, P, I, I, I, P, P, I]
    lib.probe_read.argtypes = [P, L, P, I, P]
    lib.probe_config_name.restype = ctypes.c_char_p
    lib.probe_config_name.argtypes = [I]
    lib.probe_config_weights.argtypes = [I]
    ncfg = lib.probe_configs()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for shape, K, N, nm in STREAM_SHAPES:
        nbytes = nm * K * N * 2
        ws = [torch.randn((nm, K, N), device=dev).to(torch.bfloat16)
              for _ in range(max(2, -(-(120 << 20) // nbytes)))]
        x = torch.randn((8, K), device=dev).to(torch.bfloat16)
        nw = cs.cycler(ws)
        res = {}

        def rate(name, us):
            res[name] = {"us": us, "tbps": nbytes / us / 1e6}
            print(f"  {shape} {name}: {us:.2f} us, {nbytes / us / 1e6:.3f} TB/s", flush=True)

        for cfg in range(ncfg):
            if lib.probe_config_weights(cfg) != nm:
                continue
            name = lib.probe_config_name(cfg).decode()
            for promo in (128, 256):
                def call():
                    w = nw()
                    err = lib.probe_stream(cfg, w[0].data_ptr(), w[nm - 1].data_ptr(), K, N,
                                           promo, sink.data_ptr(), stream, dev.index or 0)
                    cs.check(err == 0, f"probe_stream {cfg}: error {err}")
                rate(f"stream {name}, L2 promotion {promo} B", device_us(torch, call))

        def read():
            lib.probe_read(nw().data_ptr(), nbytes, sink.data_ptr(), 8 * sms, stream)
        rate("plain 16-byte read", device_us(torch, read))

        def cublas():
            w = nw()
            return [torch.matmul(x, w[i]) for i in range(nm)]
        rate("cuBLAS torch.matmul of 8 rows", device_us(torch, cublas))
        out[shape] = res
        del ws
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import deepspeed_tpu_torch from this checkout")
    ap.add_argument("--stream", action="store_true",
                    help="also build gemv16_probe.cu and time the weight stream alone")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS), default="",
                    help="also build and time these variants of csrc/decode.cu "
                         "(comma separated; all without a list)")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("gemv16_probe: needs a CUDA card")
    cs = chip_smoke()
    from deepspeed_tpu_torch.ops.kernels import build

    label = args.label or ("parent" if args.tree else "change")
    card = cs.gpu_identity()
    print(f"gemv16_probe {label}: {tree}; card {card}", flush=True)
    dev = torch.device("cuda", 0)
    outdir = build.BUILD_DIR.parent / "gemv16_probe"
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = start_variants([v for v in args.variants.split(",") if v], outdir)
    if args.stream:
        procs["stream"] = (outdir / "libgemv16_probe.so",
                           nvcc(ROOT / "gemv16_probe.cu", outdir / "libgemv16_probe.so",
                                ["-I", str(ROOT)]))
    build.load_library("decode")
    libs = finish(procs)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in cs.gemv16_ptxas():
        print(f"  ptxas {ln}", flush=True)
    res = {"card": card, "tree": str(tree)}
    if args.stream:
        print("the weight stream alone, device us a call under the profiler:", flush=True)
        res["stream"] = stream_sweep(torch, cs, ctypes.CDLL(str(libs.pop("stream"))), dev)
    for name, path in [("shipped", None), *libs.items()]:
        if path is not None:
            use_library(path)
        print(f"{name}: {VARIANTS[name][0] if path else 'csrc/decode.cu'}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        if path is None or VARIANTS[name][2:] != (True,):
            check(torch, cs, dev, gen)
        res[name] = cs.gemv16_times(torch, dev, gen, profile=True)
        for shape, r in res[name].items():
            gu = r.get("graph_us")
            print(f"  {shape}: device {r['device_us']:.3f} us a call (profiler), "
                  f"{'n/a' if gu is None else f'{gu:.3f}'} us replayed from a CUDA "
                  f"graph, call {r['ms']:.5f} ms, host {r['host_us']:.3f} us a call",
                  flush=True)
    (outdir / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"gemv16_probe {label}: ok", flush=True)


if __name__ == "__main__":
    main()
