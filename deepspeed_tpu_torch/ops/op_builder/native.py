"""Build and load the port's host C++ ops: g++ -> shared object -> ctypes.

Counterpart of ``deepspeed_tpu/ops/op_builder/native.py``.  Each builder
compiles its sources under ``deepspeed_tpu_torch/csrc/`` with the JAX
package's flags (so the host optimizer steps are bit-equal to its library
on one host) into ``build/torch_kernels/`` at the repository root, named by
a hash of the sources, the flags and the host CPU's feature flags (``-march=
native`` compiles for the CPU it runs on, so a library built on another CPU
is never loaded), as :mod:`deepspeed_tpu_torch.ops.kernels.build` names the
CUDA libraries: an edited source is rebuilt, an unchanged one is loaded as
it is.  Nothing is compiled at import; the first
``load()`` builds.  There is no rebuild switch and no fallback: a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_LOCK = threading.Lock()
_CACHE: Dict[str, ctypes.CDLL] = {}


def _cpu_features() -> str:
    """The machine and the CPU's feature flags (what ``-march=native``
    compiles for)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags}"


class NativeOpBuilder:
    NAME: str = ""
    SOURCES: List[str] = []          # file names under csrc/
    CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
                 "-funroll-loops"]
    LDFLAGS = ["-lpthread"]

    def lib_path(self) -> Path:
        h = hashlib.sha256()
        for s in self.SOURCES:
            h.update((CSRC / s).read_bytes())
        h.update(" ".join(self.CXX_FLAGS + self.LDFLAGS).encode())
        h.update(_cpu_features().encode())
        return BUILD_DIR / f"lib_ds_{self.NAME}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        out = self.lib_path()
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found on PATH: the host op {self.NAME} "
                               "is built from source at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *self.CXX_FLAGS, *(str(CSRC / s) for s in self.SOURCES),
               "-o", str(tmp), *self.LDFLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build of {self.NAME} failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
        return out

    def _bind(self, lib: ctypes.CDLL) -> None:
        """Set the C functions' prototypes."""

    def load(self) -> ctypes.CDLL:
        with _LOCK:
            lib = _CACHE.get(self.NAME)
            if lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                _CACHE[self.NAME] = lib
            return lib


class CPUAdamBuilder(NativeOpBuilder):
    """``csrc/cpu_adam.cpp``: ``ds_adam_step``, ``ds_adam_step_bf16g``,
    ``ds_adagrad_step`` and ``ds_lion_step``."""

    NAME = "cpu_adam"
    SOURCES = ["cpu_adam.cpp"]

    def _bind(self, lib: ctypes.CDLL) -> None:
        i64, f, i, p = ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p
        lib.ds_adam_step.argtypes = [i64, p, p, p, p, i64, f, f, f, f, f, i]
        lib.ds_adam_step.restype = None
        lib.ds_adam_step_bf16g.argtypes = [i64, p, p, p, p, p, i64, f, f, f, f, f, i]
        lib.ds_adam_step_bf16g.restype = None
        lib.ds_adagrad_step.argtypes = [i64, p, p, p, f, f, f]
        lib.ds_adagrad_step.restype = None
        lib.ds_lion_step.argtypes = [i64, p, p, p, f, f, f, f]
        lib.ds_lion_step.restype = None


class AsyncIOBuilder(NativeOpBuilder):
    """``csrc/ds_aio.cpp``: the thread-pool async file I/O handle."""

    NAME = "aio"
    SOURCES = ["ds_aio.cpp"]

    def _bind(self, lib: ctypes.CDLL) -> None:
        i64, i, p, cp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
        lib.ds_aio_handle_new.argtypes = [i, i, i, i, i, i]
        lib.ds_aio_handle_new.restype = p
        lib.ds_aio_handle_free.argtypes = [p]
        lib.ds_aio_handle_free.restype = None
        lib.ds_aio_pread_async.argtypes = [p, cp, p, i64, i64]
        lib.ds_aio_pread_async.restype = None
        lib.ds_aio_pwrite_async.argtypes = [p, cp, p, i64, i64]
        lib.ds_aio_pwrite_async.restype = None
        lib.ds_aio_wait.argtypes = [p]
        lib.ds_aio_wait.restype = i64
        lib.ds_aio_read.argtypes = [p, cp, p, i64, i64]
        lib.ds_aio_read.restype = i64
        lib.ds_aio_write.argtypes = [p, cp, p, i64, i64]
        lib.ds_aio_write.restype = i64
