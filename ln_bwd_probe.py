#!/usr/bin/env python3
"""Time the LayerNorm backward of one checkout, and copies of
``csrc/layer_norm.cu`` changed on purpose, on one CUDA card.

    python3 ln_bwd_probe.py [--tree DIR] [--variants [A,B]] [--label NAME]

Every build is timed at the training paths' shapes, bf16: gpt2-xl's
[8192, 1600] and bloom-1b7's [8192, 2048] rows (x, dy; gamma of the row's
width): the device time a call under the profiler, by kernel (the partials'
launch and their ordered sum), the call under CUDA events, and the host's
time a call, beside the bound (x and dy read once, dx written once) and
the device time of ``torch.add(x, dy, out=...)``, PyTorch's elementwise
kernel over the same bytes, as a yardstick of the rate such a stream
reaches.
Before it is timed, each build is held against the plain version (dx within
2e-2, dγ and dβ within 2e-2 relative, a second call bit-equal).

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
    """ptxas's registers and spills of the LayerNorm backward's kernels."""
    got, entry = [], ""
    for ln in lines:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif ("layer_norm_bwd" in entry or "layer_norm_dgb" in entry) and \
                ("Used" in ln or "spill" in ln):
            ty = " bf16" if "13__nv_bfloat16" in entry else " fp16" if "6__half" in entry else ""
            name = re.search(r"\d(layer_norm_[a-z_]*?kernel)", entry)
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


def measure(torch, cs, dev, checked, names):
    """{shape: {"device_us", "split", "ms", "host_us", "bound_us"}} at each
    SHAPES shape, bf16, the device time split over the kernels ``names``;
    each held to the plain version first when ``checked``."""
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
        names = ("layer_norm_bwd_",) if name == "no_sum" else ("layer_norm_bwd_", sums)
        res[name] = {"ptxas": ptx, **measure(torch, cs, dev, checked, names)}
        for shape, r in res[name].items():
            if shape == "ptxas":
                continue
            print(f"  {shape}: device {r['device_us']:.3f} us a call ("
                  + ", ".join(f"{k} {v:.3f}" for k, v in r["split"].items())
                  + f"), bound {r['bound_us']:.3f} us ({100 * r['bound_us'] / r['device_us']:.1f}"
                  f" %), torch.add of the same bytes {r['add_us']:.3f} us, call "
                  f"{r['ms']:.5f} ms, host {r['host_us']:.3f} us a call", flush=True)
    (outdir / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"ln_bwd_probe {label}: ok", flush=True)


if __name__ == "__main__":
    main()
