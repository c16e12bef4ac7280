#!/usr/bin/env python3
"""Time the flash_decode kernel of one checkout on one CUDA card, at the
shapes of the decode paths, under grid variants chosen from the host.

    python3 flash_decode_probe.py [--tree DIR] [--variants] [--label NAME]

Every run is timed by ``chip_smoke.flash_decode_paged_times`` (bf16,
256-token pages: llama3-8b's heads at the serve profile's depths, at 300
and 2048 keys, gpt2-xl's heads, the one-page window) and
``chip_smoke.flash_decode_contig_times`` (264 keys in a 512 cache, 2048 in a
2048 cache): the call under CUDA events, the kernel's device time a launch
under the profiler after a 128 MB read (the L2 cold), the host's time a
call.  Before it is timed, the kernel is held against its plain version at
those shapes within 2e-2.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from another checkout (an
unpacked parent commit: its kernel, named ``--kernel``, and its wrappers,
built in DIR/build), so that two versions are compared on one card in one
call.  ``--variants`` also times this checkout's kernel under the grids of
VARIANTS below (host-side constants of ``ops/kernels/decode.py``: no
rebuild) and the copies of ``csrc/decode.cu`` that SOURCE_VARIANTS makes
(each edit must match the source once; all builds started together; a
variant that changes the result is timed without the check).  The card's
name and power limit are printed beside the numbers; the results also go
to ``build/flash_decode_probe/<label>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# name: (what it measures, {constant of ops/kernels/decode.py: its value})
VARIANTS = {
    "fill_half": ("splits for half a wave of resident blocks (one shipped)",
                  {"_FD_FILL": 0.5}),
    "fill_2": ("splits for two waves of resident blocks", {"_FD_FILL": 2.0}),
    "chunk8k": ("chunks of 8 KB of K rows (16 KB shipped): 32 keys at Dh 128",
                {"_FD_CHUNK_BYTES": 8192}),
}

# name: (what it measures, whether the result stays right, [(text of
# csrc/decode.cu, its replacement)])
SOURCE_VARIANTS = {
    "no_merge": ("every live split writes the output itself: the merge's "
                 "cost (the result is wrong past one split)", False,
                 [("  if (live == 1) {                          // the whole row",
                   "  if (true) {                          // the whole row")]),
    "no_math": ("no score or P.V products: loads, softmax, merge (wrong)", False,
                [("    for (int v = sub; v < nvec; v += tpk) {",
                  "    for (int v = sub; v < 0; v += tpk) {"),
                 ("      for (int j = kg; j < jn; j += groups) {",
                  "      for (int j = kg; j < 0; j += groups) {")]),
    "threads128": ("128 threads a block (256 shipped)", True,
                   [("constexpr int kFdThreads = 256;", "constexpr int kFdThreads = 128;")]),
}


def build_variants(names):
    """Start nvcc on each source variant's copy of csrc/decode.cu, all
    together; returns {name: its library's path}."""
    import subprocess

    from deepspeed_tpu_torch.ops.kernels import build

    src = (build.CSRC / "decode.cu").read_text()
    outdir = build.BUILD_DIR.parent / "flash_decode_probe"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in SOURCE_VARIANTS[name][2]:
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
    import ctypes

    from deepspeed_tpu_torch.ops.kernels import build

    lib = ctypes.CDLL(str(path))
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    build._LIBS["decode"] = build.BuiltLibrary("decode", Path(path), lib, [])
    build._BOUND.clear()


def chip_smoke():
    """This checkout's chip_smoke.py as a module (never another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(torch, cs, dev, gen):
    """The kernel against its plain version at the timed shapes, bf16."""
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    bf = torch.bfloat16
    keys = cs.serve_profile_keys()
    for model, pos in (("llama3-8b", [n - 1 for n in keys]), ("gpt2-xl", [n - 1 for n in keys]),
                       ("llama3-8b", [2047] * cs.B)):
        q, k, v, p, table = cs.paged_inputs(torch, dev, gen, bf, 256, pos, model=model,
                                            window=2048)
        sc = cs.DECODE_MODELS[model]["DH"] ** -0.5
        cs._assert_close(torch, dk.flash_decode_paged_cuda(q, k, v, p, table, scale=sc, layer=1),
                         dk._flash_decode_paged_ref(q, k, v, p, table, scale=sc, layer=1,
                                                    alibi=False),
                         2e-2, f"paged {model} {max(pos) + 1} keys")
    for depth, smax in ((264, 512), (2048, 2048)):
        k = cs._randn(torch, (1, cs.B, cs.HKV, smax, cs.DH), gen, dev).to(bf)
        v = cs._randn(torch, (1, cs.B, cs.HKV, smax, cs.DH), gen, dev).to(bf)
        q = cs._randn(torch, (cs.B, cs.H, cs.DH), gen, dev).to(bf)
        cs._assert_close(torch, dk.flash_decode_contig_cuda(q, k, v, depth - 1,
                                                            scale=cs.DH ** -0.5, layer=0),
                         dk._flash_decode_ref(q, k[0], v[0], depth - 1, scale=cs.DH ** -0.5),
                         2e-2, f"contiguous {depth} keys")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import deepspeed_tpu_torch from this checkout")
    ap.add_argument("--kernel", default="flash_decode_kernel",
                    help="the kernel's name in the profile")
    ap.add_argument("--variants", action="store_true",
                    help="also time the grid variants of this checkout")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_decode_probe: needs a CUDA card")
    cs = chip_smoke()
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import decode as dk

    label = args.label or ("parent" if args.tree else "change")
    card = cs.gpu_identity()
    print(f"flash_decode_probe {label}: {tree}; card {card}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_variants(SOURCE_VARIANTS) if args.variants else {}
    build.load_library("decode")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "tree": str(tree)}
    runs = [("shipped", {}, None, "as shipped", True)]
    if args.variants:
        runs += [(n, v[1], None, v[0], True) for n, v in VARIANTS.items()]
        runs += [(n, {}, libs[n], v[0], v[1]) for n, v in SOURCE_VARIANTS.items()]
    for name, consts, lib, what, exact in runs:
        saved = {c: getattr(dk, c) for c in consts}
        for c, val in consts.items():
            setattr(dk, c, val)
        if lib is not None:
            use_library(lib)
        print(f"{name}: {what}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        if exact:
            check(torch, cs, dev, gen)
        res[name] = {"paged": cs.flash_decode_paged_times(torch, dev, gen, args.kernel),
                     "contig": cs.flash_decode_contig_times(torch, dev, gen, args.kernel)}
        for c, val in saved.items():
            setattr(dk, c, val)
    out = build.BUILD_DIR.parent / "flash_decode_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{label}.json").write_text(json.dumps(res, indent=1))
    print(f"flash_decode_probe {label}: ok", flush=True)


if __name__ == "__main__":
    main()
