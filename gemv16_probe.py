#!/usr/bin/env python3
"""Time the bf16 fused_norm_qkv and fused_proj_norm kernels of one checkout,
and of copies of ``csrc/decode.cu`` changed on purpose, on one CUDA card.

    python3 gemv16_probe.py [--tree DIR] [--variants] [--label NAME]

Every build is timed by ``chip_smoke.gemv16_times`` at the decode path's four
shapes (8 rows; llama3-8b's QKV [4096, 6144] and out-projection [4096, 4096]
with RMSNorm, gpt2-xl's [1600, 4800] and [1600, 1600] with LayerNorm and
biases): the call under CUDA events, the kernel's device time a launch under
the profiler and the host's time a call.  Before it is timed, each kernel is
held against its plain version within 2e-2 at each shape.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from another checkout (an
unpacked parent commit: its kernels and its wrappers, built in DIR/build),
so that two versions are compared on one card in one call.  ``--variants``
also builds the copies of ``csrc/decode.cu`` that VARIANTS below makes (each
edit must match the source once), all builds started together, and times
each the same way.  The card's name and power limit are printed beside the
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
# name: (what it measures, [(text of csrc/decode.cu, its replacement)])
VARIANTS = {
    "repeat": ("the shipped source again: the noise between builds", []),
    "q8_grid": ("norm_qkv on q8_grid's 1 block an SM with a 6-stage ring",
                [("using QkvCfg = G16Cfg<3, 3>;", "using QkvCfg = G16Cfg<6, 1>;")]),
    "even": ("the even split of (tile, k16) units over the resident blocks "
             "at every shape",
             [("  g.even = g.tiles > cap;\n", "  g.even = 1;\n")]),
    "no_tail": ("proj_norm without its norm: r only, no statistics, no h",
                [("    if (warp < a.bc) {\n      const float nv",
                  "    if (false) {\n      const float nv"),
                 ("  if constexpr (kProj) g16_norm<T>(a);\n", "")]),
}


def chip_smoke():
    """This checkout's chip_smoke.py as a module (never another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(torch, cs, dev, gen, skip_h):
    """Each kernel against its plain version at the four shapes, bf16."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    for model in ("llama3-8b", "gpt2-xl"):
        t = cs.decode_inputs(torch, dev, gen, bf, model=model)
        kind = cs.DECODE_MODELS[model]["kind"]
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
        for i in range(1 if skip_h else 2):
            cs._assert_close(torch, got[i], want[i], 2e-2, f"proj_norm {model} {'rh'[i]}")
        del t


def build_variants(names):
    """Start nvcc on each variant's copy of csrc/decode.cu, all together;
    returns {name: its library's path}."""
    from deepspeed_tpu_torch.ops.kernels import build

    src = (build.CSRC / "decode.cu").read_text()
    outdir = build.BUILD_DIR.parent / "gemv16_probe"
    outdir.mkdir(parents=True, exist_ok=True)
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
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import deepspeed_tpu_torch from this checkout")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the variants of csrc/decode.cu")
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
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_variants(VARIANTS) if args.variants else {}
    build.load_library("decode")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "tree": str(tree)}
    for name, path in [("shipped", None), *libs.items()]:
        if path is not None:
            use_library(path)
        print(f"{name}: {VARIANTS[name][0] if path else 'csrc/decode.cu'}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        check(torch, cs, dev, gen, skip_h=name == "no_tail")
        res[name] = cs.gemv16_times(torch, dev, gen, profile=True)
        for shape, r in res[name].items():
            print(f"  {shape}: device {r['device_us']:.3f} us a launch, call "
                  f"{r['ms']:.5f} ms, host {r['host_us']:.3f} us a call", flush=True)
    out = build.BUILD_DIR.parent / "gemv16_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"gemv16_probe {label}: ok", flush=True)


if __name__ == "__main__":
    main()
