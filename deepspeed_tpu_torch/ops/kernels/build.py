"""Build and load the port's CUDA C++ kernels.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers in the build: a file compiles in seconds instead of
minutes).  Libraries land in ``build/torch_kernels/`` at the repository
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing is compiled at
import: the first call that needs a kernel builds it.

The C functions return the ``cudaError_t`` of the launch they made (read
with ``cudaGetLastError`` right after it); :func:`check_launch` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuiltLibrary:
    """A loaded kernel library and how it was built."""

    name: str
    path: Path
    lib: ctypes.CDLL
    ptxas_info: List[str]     # `-Xptxas -v` lines (entry, registers, smem,
                              # spills, wgmma serialization warnings)


_LIBS: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source at first use")


def load_library(name: str) -> BuiltLibrary:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process."""
    built = _LIBS.get(name)
    if built is not None:
        return built
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    log = out.with_suffix(".ptxas.txt")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    info = [ln.strip() for ln in
            (log.read_text().splitlines() if log.exists() else [])
            if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln))
            or "spill" in ln or "Performance" in ln]
    built = BuiltLibrary(name, out, ctypes.CDLL(str(out)), info)
    built.lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.ds_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = built
    return built


_BOUND: Dict[Tuple[str, str], Callable[..., int]] = {}


def bind(name: str, fn: str, argtypes: list,
         restype=ctypes.c_int) -> Callable[..., int]:
    """``csrc/<name>.cu``'s C function ``fn``, built and loaded at first use,
    with its prototype set once and kept: later calls cost one dict lookup,
    and the caller passes plain ints and floats."""
    f = _BOUND.get((name, fn))
    if f is None:
        f = getattr(load_library(name).lib, fn)
        f.argtypes, f.restype = argtypes, restype
        _BOUND[(name, fn)] = f
    return f


def check_launch(built: BuiltLibrary, kernel: str, code: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = built.lib.ds_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
