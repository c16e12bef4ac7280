#!/usr/bin/env python3
"""Time the LayerNorm and RMSNorm kernels of one checkout, and copies of
``csrc/layer_norm.cu`` changed on purpose, on one CUDA card.

    python3 ln_bwd_probe.py [--tree DIR] [--variants [A,B]] [--label NAME]
                            [--kernels fwd,bwd] [--check-only]

Every build is timed at the paths' shapes, bf16.

- The forwards (``fwd``), through ``chip_smoke.norm_fwd_times``: LayerNorm
  at gpt2-xl's decode and prefill rows [8, 1600] and [64, 1600] and the
  training rows [8192, 1600] and bloom-1b7's [8192, 2048]; RMSNorm at
  llama3-8b's [8, 4096] and [64, 4096], generate()'s prefill [1600, 4096]
  and llama-1b4's training rows [8192, 2048].  For each: the device time a
  launch under the profiler with x cycled through copies past the 50 MB L2
  ("alone"), the device time a call replayed from a CUDA graph of 20 calls
  on 20 copies (``graph_us``: the host's launches taken out, as a
  host-bound decode loop cannot), the call under CUDA events, the host's
  time a call, and the same four for ``F.layer_norm`` / ``F.rms_norm``,
  beside the bound (x read once, y written once, the scale once).
- The backwards (``bwd``): the LayerNorm backward at gpt2-xl's [8192, 1600]
  and bloom-1b7's [8192, 2048] rows (x, dy; gamma of the row's width), and
  the RMSNorm backward at llama-1b4's [8192, 2048], mixtral-8x7b's (and
  llama3-8b's) [8192, 4096] and mixtral-tiny's [2048, 256] train rows:
  the device time a call under the profiler, by kernel (the partials'
  launch and their ordered sum), the call under CUDA events, and the
  host's time a call, beside the bound (x and dy read once, dx written
  once) and the device time of
  ``torch.add(x, dy, out=...)``, PyTorch's elementwise kernel over the same
  bytes, as a yardstick of the rate such a stream reaches; for RMSNorm also
  ``F.rms_norm``'s autograd backward on the same inputs.

Before it is timed, each build is held against the plain version (y and dx
within 2e-2, dγ and dβ within 2e-2 relative, a second call bit-equal);
``--check-only`` prints ptxas's registers and spills, checks, and stops.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from another checkout (an
unpacked parent commit, built in DIR/build), so that two versions are
compared on one card in one call.  ``--variants`` also builds the copies of
``csrc/layer_norm.cu`` that VARIANTS below makes (each edit must match the
source once; all of them, or those named), all builds started together.
The card's name and power limit are printed beside the numbers; the results
also go to ``build/ln_bwd_probe/<label>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8192, 1600), (8192, 2048))
_SUM = ("  layer_norm_dgb_sum_kernel<T><<<(2 * n + 31) / 32, kThreads, 0, stream>>>(\n"
        "      part, static_cast<T*>(dgb), nblk, 2 * n);\n")
_WARPS4 = ("constexpr int kBwdWarps = 8;", "constexpr int kBwdWarps = 4;")
_PREFETCH = "    if (r + stride < rows) load(r + stride, nx, nd);\n"
_TREE = "(({0}[0] + {0}[1]) + ({0}[2] + {0}[3])) + (({0}[4] + {0}[5]) + ({0}[6] + {0}[7]))"
# name: (what it measures, [(text of csrc/layer_norm.cu, its replacement)],
# and True where the edit breaks the results: timed, not checked)
VARIANTS = {
    "repeat": ("the shipped source again: the noise between builds", []),
    "one_block_sum": ("the partials summed by one block, as the last block to take a "
                      "ticket would sum them",
                      [(_SUM, _SUM.replace("(2 * n + 31) / 32", "1"))]),
    "no_sum": ("no sum of the partials: the partials' launch alone", [(_SUM, "")], True),
    "no_prefetch": ("each row's x and dy loaded when it is reduced, not a row ahead",
                    [("    P nx[kV], nd[kV];\n"
                      "    if (r + stride < rows) load(r + stride, nx, nd);\n", ""),
                     ("#pragma unroll\n    for (int i = 0; i < kV; ++i) {\n"
                      "      cx[i] = nx[i];\n      cd[i] = nd[i];\n    }\n",
                      "    if (r + stride < rows) load(r + stride, cx, cd);\n")]),
    "no_smem": ("no dg and db partials in shared memory (timed only: the "
                "partials' cost)",
                [("          *sg = a;\n          *sb = b;\n", "")], True),
    "warps4": ("4 warps a block (rows in flight a block), 2 blocks an SM",
               [_WARPS4]),
    "warps4_lb3": ("4 warps a block, registers capped for 3 blocks an SM",
                   [_WARPS4, ("__global__ void __launch_bounds__(kBwdWarps * 32)\n"
                              "layer_norm_bwd_warp_kernel",
                              "__global__ void __launch_bounds__(kBwdWarps * 32, 3)\n"
                              "layer_norm_bwd_warp_kernel")]),
    "l2_ahead": ("each warp's row after next asked into L2 (a bulk prefetch of x's and "
                 "dy's row by one lane) beside the registers' row ahead",
                 [(_PREFETCH, _PREFETCH + (
                     "    if (lane == 0 && r + 2 * stride < rows) {\n"
                     "      const uint32_t nb = static_cast<uint32_t>(n * sizeof(T));\n"
                     "      asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::"
                     "\"l\"(x + (r + 2 * stride) * n), \"r\"(nb) : \"memory\");\n"
                     "      asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::"
                     "\"l\"(dy + (r + 2 * stride) * n), \"r\"(nb) : \"memory\");\n"
                     "    }\n"))]),
    "stream_hints": ("x and dy loaded, dx stored with the streaming cache hints "
                     "(__ldcs, __stcs: evict first)",
                     [("        px[i] = xv[c];\n        pd[i] = dv[c];\n",
                       "        const float4 tx = __ldcs(reinterpret_cast<const float4*>(xv + c));\n"
                       "        const float4 td = __ldcs(reinterpret_cast<const float4*>(dv + c));\n"
                       "        __builtin_memcpy(&px[i], &tx, 16);\n        __builtin_memcpy(&pd[i], &td, 16);\n"),
                      ("        ov[c] = out;\n",
                       "        float4 to;\n        __builtin_memcpy(&to, &out, 16);\n"
                       "        __stcs(reinterpret_cast<float4*>(ov + c), to);\n")]),
    "g_global": ("gamma read from global memory (through L1) in each pass, not "
                 "staged in shared memory",
                 [("  P* gs = reinterpret_cast<P*>(slices + kBwdWarps * per);   // gamma, staged once\n"
                   "  for (int c = threadIdx.x; c < nv; c += kBwdWarps * 32) gs[c] = gv[c];\n"
                   "  __syncthreads();\n", "  const P* gs = gv;\n")]),
    "no_alloc": ("x and dy loaded without allocating in L1 (ld.global.nc.L1::no_allocate)",
                 [("        px[i] = xv[c];\n        pd[i] = dv[c];\n",
                   "        uint4 tx, td;\n"
                   "        asm(\"ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
                   "            : \"=r\"(tx.x), \"=r\"(tx.y), \"=r\"(tx.z), \"=r\"(tx.w) : \"l\"(xv + c));\n"
                   "        asm(\"ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
                   "            : \"=r\"(td.x), \"=r\"(td.y), \"=r\"(td.z), \"=r\"(td.w) : \"l\"(dv + c));\n"
                   "        __builtin_memcpy(&px[i], &tx, 16);\n"
                   "        __builtin_memcpy(&pd[i], &td, 16);\n")]),
    "tree": ("each vector's terms of the four sums added as a tree (shorter "
             "dependence chains)",
             [("        const P pg = gs[c];\n#pragma unroll\n        for (int j = 0; j < P::N; ++j) {\n"
               "          sx +=",
               "        const P pg = gs[c];\n        float a[P::N], b[P::N];\n#pragma unroll\n"
               "        for (int j = 0; j < P::N; ++j) {\n          sx +="),
              ("        const P pg = gs[c];\n#pragma unroll\n        for (int j = 0; j < P::N; ++j) {\n"
               "          const float xc",
               "        const P pg = gs[c];\n        float a[P::N], b[P::N];\n#pragma unroll\n"
               "        for (int j = 0; j < P::N; ++j) {\n          const float xc"),
              ("          sx += to_f32(cx[i].v[j]);\n"
               "          sw += to_f32(cd[i].v[j]) * to_f32(pg.v[j]);\n        }\n",
               "          a[j] = to_f32(cx[i].v[j]);\n"
               "          b[j] = to_f32(cd[i].v[j]) * to_f32(pg.v[j]);\n        }\n"
               "        sx += " + _TREE.format("a") + ";\n        sw += " + _TREE.format("b")
               + ";\n"),
              ("          sq += xc * xc;\n"
               "          swx += to_f32(cd[i].v[j]) * to_f32(pg.v[j]) * xc;\n        }\n",
               "          a[j] = xc * xc;\n"
               "          b[j] = to_f32(cd[i].v[j]) * to_f32(pg.v[j]) * xc;\n        }\n"
               "        sq += " + _TREE.format("a") + ";\n        swx += " + _TREE.format("b")
               + ";\n")]),
}
VARIANTS["l2_ahead_hints"] = ("l2_ahead and stream_hints together",
                              VARIANTS["l2_ahead"][1] + VARIANTS["stream_hints"][1])
# RMSNorm's backward shapes: llama-1b4's and mixtral-8x7b's train rows, and
# mixtral-tiny's (one-warp blocks of the row kernel)
RMS_SHAPES = ((8192, 2048), (8192, 4096), (2048, 256))
_ROW_LOADS = ("      px[i] = xv[c];\n      pg[i] = gv[c];\n"
              "      if constexpr (kLayer) pb[i] = bv[c];\n")
_ROW_OUT = "    if (c < nv) yv[c] = norm_out<kLayer, T>(px[i], pg[i], pb[i], st);\n"
_STREAM_OUT = ("        const P pb = sb[c];     // g read in place: a copy of both, 148 registers\n"
               "        store_streaming(yv + c, norm_out<true, T>(cx[i], sg[c], pb, st));\n")
# the forwards' variants (names start with fwd_)
VARIANTS.update({
    "fwd_two_trips": ("the row kernel asks for g and b after the statistics (the parent's "
                      "order: two trips to memory a row)",
                      [(_ROW_LOADS, "      px[i] = xv[c];\n"),
                       (_ROW_OUT, "    if (c < nv) {\n      pg[i] = gv[c];\n"
                        "      if constexpr (kLayer) pb[i] = bv[c];\n"
                        "      yv[c] = norm_out<kLayer, T>(px[i], pg[i], pb[i], st);\n    }\n")]),
    "fwd_row_vecs4": ("the row kernel's thread holds 4 vectors of a row, not 2",
                      [("constexpr int kRowVecs = 2;", "constexpr int kRowVecs = 4;")]),
    "fwd_row_vecs1": ("the row kernel's thread holds 1 vector of a row, not 2",
                      [("constexpr int kRowVecs = 2;", "constexpr int kRowVecs = 1;")]),
    "fwd_no_stream": ("LayerNorm's streaming kernel never taken: the row kernel at every "
                      "row count",
                      [("  if (n / Pack<T>::N <= 32 * kLaneVecs && rows > "
                        "static_cast<long long>(sms) * kFwdWarps) {", "  if (false) {")]),
    "fwd_no_prefetch": ("the streaming kernel loads each row's x when it reduces it, not a "
                        "row ahead",
                        [("    P nx[kLaneVecs];\n    if (r + stride < rows) load(r + stride, "
                          "nx);\n", ""),
                         ("#pragma unroll\n    for (int i = 0; i < kLaneVecs; ++i) cx[i] = "
                          "nx[i];\n", "    if (r + stride < rows) load(r + stride, cx);\n")]),
    "fwd_g_global": ("the streaming kernel reads g and b from global memory in every row, "
                     "not staged in shared memory",
                     [(_STREAM_OUT, "        const P pg = gv[c], pb = bv[c];\n"
                       "        store_streaming(yv + c, norm_out<true, T>(cx[i], pg, pb, st));\n")]),
    "fwd_stream_plain_store": ("the streaming kernel stores y without the streaming hint",
                               [(_STREAM_OUT, "        const P pb = sb[c];\n"
                                 "        yv[c] = norm_out<true, T>(cx[i], sg[c], pb, st);\n")]),
    "fwd_warps4": ("streaming blocks of 4 warps",
                   [("constexpr int kFwdWarps = 8;", "constexpr int kFwdWarps = 4;")]),
})


def chip_smoke():
    """This checkout's chip_smoke.py as a module (never another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_variants(names, outdir):
    """Start nvcc on each variant's copy of csrc/layer_norm.cu; returns
    {name: (its library's path, the process)}."""
    import subprocess

    from deepspeed_tpu_torch.ops.kernels import build

    src = (build.CSRC / "layer_norm.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is in csrc/layer_norm.cu "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        cu = outdir / f"layer_norm_{name}.cu"
        cu.write_text(text)
        lib = outdir / f"liblayer_norm_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def finish(procs):
    """Wait for the builds; {name: (library path, ptxas lines of the
    LayerNorm backward's kernels)}."""
    out = {}
    for name, (lib, p) in procs.items():
        so, se = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{so}\n{se}")
        out[name] = (lib, ptxas_lines(se.splitlines()))
    return out


def ptxas_lines(lines):
    """ptxas's registers and spills of both backwards' kernels and of both
    forwards'."""
    got, entry = [], ""
    for ln in lines:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif any(k in entry for k in ("layer_norm_bwd", "layer_norm_dgb", "norm_fwd",
                                      "rms_norm_bwd", "rms_dg_reduce")) and \
                ("Used" in ln or "spill" in ln):
            ty = " bf16" if "13__nv_bfloat16" in entry else " fp16" if "6__half" in entry else ""
            name = re.search(r"\d((?:layer|rms)_norm_[a-z_]*?kernel)", entry)
            got.append(f"{name.group(1) if name else entry[:60]}{ty}: "
                       f"{ln.split(':')[-1].strip()}")
    return got


def use_library(path):
    """Make the LayerNorm wrappers call the library at ``path``."""
    from deepspeed_tpu_torch.ops.kernels import build

    lib = ctypes.CDLL(str(path))
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    build._LIBS["layer_norm"] = build.BuiltLibrary("layer_norm", Path(path), lib, [])
    build._BOUND.clear()


def rms_bwd_measure(torch, cs, dev, checked):
    """The RMSNorm backward at each RMS_SHAPES shape, bf16: device us a call
    by kernel, call ms, host us a call, the bound, ``torch.add`` over the
    same bytes and ``F.rms_norm``'s autograd backward; each held to the
    plain version first when ``checked``."""
    import torch.nn.functional as F_

    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    out = {}
    for shape in RMS_SHAPES:
        n = shape[-1]
        gen = torch.Generator(device=dev).manual_seed(0)
        x, g, _, dy = cs._ln_inputs(torch, dev, gen, torch.bfloat16, shape)
        if checked:
            got, again = (ln.rms_norm_bwd_cuda(x, g, dy, 1e-5),
                          ln.rms_norm_bwd_cuda(x, g, dy, 1e-5))
            want = ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, c) for a, c in zip(got, again)),
                     f"rms_norm_bwd {shape}: two calls differ")
            cs._assert_close(torch, got[0], want[0], 2e-2, f"rms_norm_bwd dx {shape}")
            cs.check(cs._rel_err(got[1], want[1]) < 2e-2, f"rms_norm_bwd dγ {shape}")

        def call():
            return ln.rms_norm_bwd_cuda(x, g, dy, 1e-5)
        split = cs.kernel_split(torch, call, cs.RMS_BWD_KERNELS,
                                f"rms_norm_bwd {list(shape)}", calls=50)
        buf = torch.empty_like(x)
        add = cs.kernel_split(torch, lambda: torch.add(x, dy, out=buf), ("elementwise",),
                              f"torch.add x + dy {list(shape)}", calls=50)
        lx, lg = x.clone().requires_grad_(), g.clone().requires_grad_()
        ly = F_.rms_norm(lx, (n,), lg, eps=1e-5)
        out[f"{shape[0]}x{n}"] = {
            "device_us": sum(split.values()), "split": split,
            "add_us": add["elementwise"], "ms": cs.time_ms(torch, call),
            "library_ms": cs.time_ms(torch, lambda: torch.autograd.grad(
                ly, (lx, lg), dy, retain_graph=True)),
            "host_us": cs.host_us(torch, call, calls=1000),
            "bound_us": cs.bound_ms((3 * x.numel() + 3 * n) * 2, 10 * x.numel())[0] * 1e3}
        del x, g, dy, buf, lx, lg, ly
    return out


def measure(torch, cs, dev, checked, names):
    """{shape: {"device_us", "split", "ms", "host_us", "bound_us"}} of the
    LayerNorm backward at each SHAPES shape, bf16, the device time split
    over the kernels ``names``; each held to the plain version first when
    ``checked``."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    out = {}
    for shape in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x, g, _, dy = cs._ln_inputs(torch, dev, gen, torch.bfloat16, shape)
        if checked:
            got = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            again = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
            want = ln.layer_norm_bwd_plain(x, g, dy, 1e-5)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"layer_norm_bwd {shape}: two calls differ")
            cs._assert_close(torch, got[0], want[0], 2e-2, f"layer_norm_bwd dx {shape}")
            rel = max(cs._rel_err(got[1], want[1]), cs._rel_err(got[2], want[2]))
            cs.check(rel < 2e-2, f"layer_norm_bwd dγ/dβ {shape}: relative error {rel}")

        def call():
            return ln.layer_norm_bwd_cuda(x, g, dy, 1e-5)
        split = cs.kernel_split(torch, call, names, f"layer_norm_bwd {list(shape)}",
                                calls=50)
        n = shape[-1]
        buf = torch.empty_like(x)
        add = cs.kernel_split(torch, lambda: torch.add(x, dy, out=buf), ("elementwise",),
                              f"torch.add x + dy {list(shape)}", calls=50)
        out[f"{shape[0]}x{n}"] = {
            "device_us": sum(split.values()), "split": split,
            "add_us": add["elementwise"],
            "ms": cs.time_ms(torch, call), "host_us": cs.host_us(torch, call, calls=1000),
            "bound_us": cs.bound_ms((3 * x.numel() + 3 * n) * 2, 14 * x.numel())[0] * 1e3}
        del x, g, dy, buf
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import deepspeed_tpu_torch from this checkout")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS), default="",
                    help="also build and time these variants of csrc/layer_norm.cu "
                         "(comma separated; all without a list)")
    ap.add_argument("--kernels", default="fwd,bwd",
                    help="fwd (both forwards), bwd (both backwards), or both")
    ap.add_argument("--check-only", action="store_true",
                    help="print ptxas's lines, hold each build to the plain "
                         "versions at the path shapes, and stop")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("ln_bwd_probe: needs a CUDA card")
    cs = chip_smoke()
    from deepspeed_tpu_torch.ops.kernels import build

    label = args.label or ("parent" if args.tree else "change")
    card = cs.gpu_identity()
    print(f"ln_bwd_probe {label}: {tree}; card {card}", flush=True)
    dev = torch.device("cuda", 0)
    outdir = build.BUILD_DIR.parent / "ln_bwd_probe"
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = start_variants([v for v in args.variants.split(",") if v], outdir)
    shipped = build.load_library("layer_norm")
    libs = finish(procs)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "tree": str(tree)}
    kinds = args.kernels.split(",")
    # the partials' sum: its own kernel since the warp kernel came, RMSNorm's before
    sums = ("layer_norm_dgb_sum_kernel"
            if "layer_norm_dgb_sum_kernel" in (tree / "deepspeed_tpu_torch" / "csrc" /
                                               "layer_norm.cu").read_text()
            else "rms_dg_reduce_kernel")
    for name, (path, ptx) in [("shipped", (None, ptxas_lines(shipped.ptxas_info))),
                              *libs.items()]:
        if path is not None:
            use_library(path)
        print(f"{name}: {VARIANTS[name][0] if path else 'csrc/layer_norm.cu'}", flush=True)
        for ln in ptx:
            print(f"  ptxas {ln}", flush=True)
        checked = path is None or VARIANTS[name][2:] != (True,)
        row = res[name] = {"ptxas": ptx}
        if args.check_only:
            check_all(torch, cs, dev)
            continue
        if "fwd" in kinds and (path is None or name.startswith("fwd_") or name == "repeat"):
            for kind in ("layer_norm", "rms_norm"):
                row[kind] = cs.norm_fwd_times(torch, dev, kind, checked)
        if "bwd" in kinds and not name.startswith("fwd_"):
            names = ("layer_norm_bwd_",) if name == "no_sum" else ("layer_norm_bwd_", sums)
            row["layer_norm_bwd"] = measure(torch, cs, dev, checked, names)
            for shape, r in row["layer_norm_bwd"].items():
                print(f"  layer_norm_bwd {shape}: device {r['device_us']:.3f} us a call ("
                      + ", ".join(f"{k} {v:.3f}" for k, v in r["split"].items())
                      + f"), bound {r['bound_us']:.3f} us ("
                      f"{100 * r['bound_us'] / r['device_us']:.1f} %), torch.add of the same "
                      f"bytes {r['add_us']:.3f} us, call {r['ms']:.5f} ms, host "
                      f"{r['host_us']:.3f} us a call", flush=True)
        if "bwd" in kinds and (path is None or name == "repeat"):
            row["rms_norm_bwd"] = rms_bwd_measure(torch, cs, dev, checked)
            for shape, r in row["rms_norm_bwd"].items():
                print(f"  rms_norm_bwd {shape}: device {r['device_us']:.3f} us a call ("
                      + ", ".join(f"{k} {v:.3f}" for k, v in r["split"].items())
                      + f"), bound {r['bound_us']:.3f} us ("
                      f"{100 * r['bound_us'] / r['device_us']:.1f} %), torch.add of the same "
                      f"bytes {r['add_us']:.3f} us, call {r['ms']:.5f} ms, F.rms_norm "
                      f"backward {r['library_ms']:.5f} ms, host {r['host_us']:.3f} us a "
                      f"call", flush=True)
    (outdir / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"ln_bwd_probe {label}: ok", flush=True)


def check_all(torch, cs, dev):
    """Both forwards at their path shapes, fp32, bf16 and fp16, and both
    backwards at the training shapes, against their plain versions; a second
    call bit-equal."""
    from deepspeed_tpu_torch.ops.kernels import layer_norm as ln

    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
    for dt in tol:
        for kind, shapes in cs.NORM_FWD_SHAPES.items():
            layer = kind == "layer_norm"
            cuda, plain = ((ln.layer_norm_cuda, ln.layer_norm_plain) if layer
                           else (ln.rms_norm_cuda, ln.rms_norm_plain))
            n = shapes[0][1]
            for shape in (*shapes, (133, n), (1, n), (7, 100)):
                gen = torch.Generator(device=dev).manual_seed(1)
                x, g, b, _ = cs._ln_inputs(torch, dev, gen, dt, shape)
                args = (g, b) if layer else (g,)
                got, again = cuda(x, *args, 1e-5), cuda(x, *args, 1e-5)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, again), f"{kind} {dt} {shape}: two calls differ")
                e = cs._assert_close(torch, got, plain(x, *args, 1e-5), tol[dt],
                                     f"{kind} {dt} {shape}")
                print(f"  check {kind} {dt} {list(shape)}: max abs err {e:.3g}, "
                      "second call bit-equal", flush=True)
        for shape in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(2)
            x, g, _, dy = cs._ln_inputs(torch, dev, gen, dt, shape)
            got, want = ln.layer_norm_bwd_cuda(x, g, dy, 1e-5), ln.layer_norm_bwd_plain(x, g, dy, 1e-5)
            e = cs._assert_close(torch, got[0], want[0], tol[dt], f"layer_norm_bwd {dt} {shape}")
            got, want = ln.rms_norm_bwd_cuda(x, g, dy, 1e-5), ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
            e2 = cs._assert_close(torch, got[0], want[0], tol[dt], f"rms_norm_bwd {dt} {shape}")
            print(f"  check layer_norm_bwd / rms_norm_bwd {dt} {list(shape)}: dx max abs err "
                  f"{e:.3g} / {e2:.3g}", flush=True)
        for shape in (*RMS_SHAPES[1:], (8191, 2048), (777, 4096)):
            gen = torch.Generator(device=dev).manual_seed(3)
            x, g, _, dy = cs._ln_inputs(torch, dev, gen, dt, shape)
            got, again = (ln.rms_norm_bwd_cuda(x, g, dy, 1e-5),
                          ln.rms_norm_bwd_cuda(x, g, dy, 1e-5))
            want = ln.rms_norm_bwd_plain(x, g, dy, 1e-5)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"rms_norm_bwd {dt} {shape}: two calls differ")
            e = cs._assert_close(torch, got[0], want[0], tol[dt], f"rms_norm_bwd {dt} {shape}")
            rel = cs._rel_err(got[1], want[1])
            cs.check(rel < max(tol[dt], 1e-4), f"rms_norm_bwd dγ {dt} {shape}: {rel}")
            print(f"  check rms_norm_bwd {dt} {list(shape)}: dx max abs err {e:.3g}, dγ "
                  f"relative {rel:.3g}, second call bit-equal", flush=True)


if __name__ == "__main__":
    main()
