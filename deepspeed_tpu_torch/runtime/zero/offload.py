"""ZeRO-Offload / ZeRO-Infinity: host-resident optimizer states.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``.  The card keeps
only the compute-dtype params and the gradient accumulator; the fp32
master params and the optimizer moments live in host memory (``cpu``) or
on NVMe behind the aio library (``nvme``).  The optimizer-boundary step
is, one leaf at a time:

  card grads --(D2H)--> host
  the host stepper (csrc/cpu_adam.cpp, threaded C++) steps master/aux
  updated master --cast--> compute dtype --(H2D)--> card params

For NVMe each leaf's state lives in one file, streamed through a small
buffer pool with read-ahead: while leaf ``i`` is stepped, the read of
``i+1`` is in flight on the aio handle.  Host state is CPU torch tensors;
the int8 store (``int8_masters``) is the numpy blockwise codec of
:mod:`deepspeed_tpu_torch.comm.quant`.  The engine's relay (the D2H and
H2D staging) is :mod:`.relay`.

Leaves are numbered in ``jax.tree_util``'s order of the params tree (a
dict's keys sorted), as the JAX class numbers them, so ``state_{i}.bin``
and a checkpoint's ``leaf{i}.*.npy`` name the same leaf in both packages.

Over data-parallel ranks each rank's optimizer holds its slices of the
leaves its ZeRO stage shards (the engine builds it over them); under
``nvme`` each rank swaps in a directory of its own under the path
(``swap_rank``).  A checkpoint's ``leaf{i}.*.npy`` then stay whole: rank 0
creates each file at the leaf's full size (:meth:`create_state_files`) and
every rank writes its slice's region into it (:meth:`write_state` with
``places``), so the files are those of one process, and a load reads the
region of its own slices (:meth:`read_state`) at any world size or stage.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm.quant import dequantize_blockwise_np, quantize_blockwise_np
from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.lion import DeepSpeedCPULion
from deepspeed_tpu_torch.runtime.checkpoint_engine.sharded import keystr, tree_flatten_with_path

logger = logging.getLogger(__name__)


def _host_copy(leaf) -> torch.Tensor:
    """A fresh flat fp32 CPU tensor holding ``leaf`` (a tensor on any
    device, or an array)."""
    t = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.asarray(leaf))
    # zeroed first when the copy comes from the card: the pages are touched
    # by all of torch's threads, not one at a time inside the copy
    out = (torch.zeros if t.is_cuda else torch.empty)(t.numel(), dtype=torch.float32)
    out.copy_(t.detach().reshape(-1))
    return out


class OffloadedOptimizer:
    """fp32 master + optimizer moments on host RAM or NVMe, stepped by the
    native host kernels (cpu_adam / cpu_adagrad / cpu_lion).

    ``params_host`` is the params' nested dict (tensors on any device, or
    arrays).  ``backend`` is "cpu" or "nvme"; for "nvme", ``swap_dir``
    holds one state file per leaf ([master, *aux slots] fp32 concatenated)
    and reads run one leaf ahead through the aio handle.  ``opt_type`` is
    "adam", "adagrad" or "lion" (DeepSpeedCPUAdam / DeepSpeedCPUAdagrad /
    DeepSpeedCPULion)."""

    N_AUX = {"adam": 2, "adagrad": 1, "lion": 1}
    AUX_NAMES = {"adam": ("exp_avg", "exp_avg_sq"), "adagrad": ("exp_avg_sq",),
                 "lion": ("exp_avg",)}
    # which aux slots hold a non-negative second moment (coded in sqrt
    # space under int8_masters, the Adam8bit convention)
    SQRT_AUX = {"adam": (False, True), "adagrad": (True,), "lion": (False,)}

    def __init__(self, params_host: Any, *, backend: str = "cpu",
                 lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 swap_dir: Optional[str] = None, aio_config=None,
                 pipeline: bool = True, pipeline_write: bool = True,
                 opt_type: str = "adam", int8_masters: bool = False,
                 quant_block: int = 256, swap_rank: Optional[int] = None):
        if backend not in ("cpu", "nvme"):
            raise ValueError(f"offload backend {backend!r}: cpu or nvme")
        if opt_type not in self.N_AUX:
            raise ValueError(f"offload optimizer type {opt_type!r}: "
                             f"{sorted(self.N_AUX)}")
        if int8_masters and backend != "cpu":
            raise ValueError("offload_optimizer.int8_masters supports the "
                             "cpu backend (nvme state files stay fp32 — the "
                             "aio path already pipelines its bandwidth)")
        self.int8_masters = bool(int8_masters)
        self.quant_block = int(quant_block)
        self.backend = backend
        self.opt_type = opt_type
        if opt_type == "adam":
            self.adam = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps,
                                         weight_decay=weight_decay,
                                         adamw_mode=adamw_mode)
            self._stepper = self.adam
        elif opt_type == "adagrad":
            self.adam = None
            self._stepper = DeepSpeedCPUAdagrad(lr=lr, eps=eps,
                                                weight_decay=weight_decay)
        else:
            self.adam = None
            self._stepper = DeepSpeedCPULion(lr=lr, betas=betas,
                                             weight_decay=weight_decay)
        self.step_count = 0
        self.pipeline = pipeline            # read-ahead (aio pipeline_read)
        self.pipeline_write = pipeline_write  # async write-back
        self.n_aux = self.N_AUX[opt_type]
        flat = tree_flatten_with_path(params_host)
        self._paths = [keystr(kp) for kp, _ in flat]
        leaves = [leaf for _, leaf in flat]
        self._shapes = [tuple(leaf.shape) for leaf in leaves]
        self._sizes = [int(np.prod(s)) for s in self._shapes]

        self._master: Optional[List[torch.Tensor]] = None
        self._aux: Optional[List[List[torch.Tensor]]] = None
        self._swapper = None
        if backend == "cpu" and self.int8_masters:
            # the int8 host tier: master + moments as blockwise int8 (q +
            # fp32 block scales), ~(1+n_aux) bytes a param; a step
            # dequantizes one leaf to fp32, runs the native kernel and
            # requantizes, so only O(leaf) fp32 ever exists
            self._master_q: List = []
            self._aux_q: List[List] = [[] for _ in range(self.n_aux)]
            sqrt_aux = self.SQRT_AUX[opt_type]
            for leaf in leaves:
                a = _host_copy(leaf).numpy()
                self._master_q.append(quantize_blockwise_np(a, self.quant_block))
                for k in range(self.n_aux):
                    self._aux_q[k].append(quantize_blockwise_np(
                        np.zeros_like(a), self.quant_block,
                        sqrt_space=sqrt_aux[k]))
        elif backend == "cpu":
            self._master = [_host_copy(leaf) for leaf in leaves]
            self._aux = [[torch.zeros_like(p) for p in self._master]
                         for _ in range(self.n_aux)]
        else:
            from deepspeed_tpu_torch.runtime.swap_tensor import OptimizerStateSwapper

            if not swap_dir:
                raise ValueError("nvme offload requires offload_optimizer.nvme_path")
            self._swapper = OptimizerStateSwapper(swap_dir, self._sizes,
                                                  aio_config=aio_config,
                                                  n_slots=1 + self.n_aux,
                                                  rank=swap_rank)
            for i, leaf in enumerate(leaves):
                self._swapper.initialize(i, _host_copy(leaf))
        logger.info("offloaded optimizer: %d tensors, %.1fM elements, "
                    "backend=%s, type=%s%s", len(leaves),
                    sum(self._sizes) / 1e6, backend, opt_type,
                    ", int8 blockwise masters+moments" if self.int8_masters
                    else "")

    def state_bytes(self) -> int:
        """Host bytes the optimizer state holds: the fp32 masters and
        moments, the int8 codes and scales, or (nvme) the swap buffers."""
        if self.int8_masters:
            return sum(q.nbytes + s.nbytes for q, s in self._master_q) + sum(
                q.nbytes + s.nbytes for aux in self._aux_q for q, s in aux)
        if self.backend == "cpu":
            return 4 * (1 + self.n_aux) * sum(self._sizes)
        return sum(b.numel() * 4 for b in self._swapper._buffers)

    # -- int8 host-tier codec ------------------------------------------------
    def _dequant_master(self, i: int) -> torch.Tensor:
        q, s = self._master_q[i]
        return torch.from_numpy(dequantize_blockwise_np(q, s, self._sizes[i]))

    def _dequant_aux(self, i: int) -> List[torch.Tensor]:
        sqrt_aux = self.SQRT_AUX[self.opt_type]
        return [torch.from_numpy(dequantize_blockwise_np(
            *self._aux_q[k][i], n=self._sizes[i], sqrt_space=sqrt_aux[k]))
            for k in range(self.n_aux)]

    def _requant_leaf(self, i: int, master: torch.Tensor,
                      aux: List[torch.Tensor]) -> None:
        sqrt_aux = self.SQRT_AUX[self.opt_type]
        self._master_q[i] = quantize_blockwise_np(master.numpy(), self.quant_block)
        for k in range(self.n_aux):
            a = aux[k].numpy()
            if sqrt_aux[k]:
                # tiny negative fp noise stays out of the sqrt-space code
                a = np.maximum(a, 0.0)
            self._aux_q[k][i] = quantize_blockwise_np(
                a, self.quant_block, sqrt_space=sqrt_aux[k])

    def relay_leaf(self, i: int):
        """(q int8 [nb, block], scale fp32 [nb, 1]) of master leaf ``i``:
        the int8 relay payload the engine ships H2D and dequantizes on the
        card instead of a wide compute-dtype array."""
        if not self.int8_masters:
            raise RuntimeError("relay_leaf needs int8_masters")
        return self._master_q[i]

    # ------------------------------------------------------------------
    # streaming per-leaf API: begin_step -> step_leaf* -> end_step
    # ------------------------------------------------------------------
    def begin_step(self, lr: Optional[float] = None) -> None:
        if lr is not None:
            self._stepper.lr = lr
        self.step_count += 1
        if self.backend == "nvme" and self._sizes:
            self._swapper.prefetch(0)

    def _fetch_leaf(self, i: int):
        """(master, aux, release token or None) for leaf i, with
        read-ahead.  Under ``int8_masters`` the fp32 tensors are transient
        dequants of the int8 store; the token routes them back through
        requantization."""
        if self.backend == "cpu" and self.int8_masters:
            master = self._dequant_master(i)
            aux = self._dequant_aux(i)
            return master, aux, ("q", master, aux)
        if self.backend == "cpu":
            return self._master[i], [a[i] for a in self._aux], None
        buf = self._swapper.wait_fetch(i)
        if self.pipeline and i + 1 < len(self._sizes):
            self._swapper.prefetch(i + 1)
        sz = self._sizes[i]
        master = buf[:sz]
        aux = [buf[(k + 1) * sz:(k + 2) * sz] for k in range(self.n_aux)]
        return master, aux, buf

    def _release_leaf(self, i: int, buf) -> None:
        if buf is None:
            return
        if isinstance(buf, tuple) and buf[0] == "q":
            self._requant_leaf(i, buf[1], buf[2])
            return
        if self.pipeline_write:
            self._swapper.writeback(i, buf)
        else:
            self._swapper.write_sync(i, buf)
        if not self.pipeline and i + 1 < len(self._sizes):
            self._swapper.prefetch(i + 1)

    def _check_grad(self, i: int, g: torch.Tensor) -> None:
        if g.numel() != self._sizes[i]:
            raise ValueError(
                f"leaf {i} grad size {g.numel()} != {self._sizes[i]} (grads "
                f"must follow tree-leaf order — the native kernel would read "
                f"past a short buffer)")

    def step_leaf(self, i: int, g: torch.Tensor,
                  return_master: bool = True) -> Optional[torch.Tensor]:
        """Step one leaf from a flat fp32 grad; returns the fp32 master
        (under ``int8_masters`` the post-requant value, what the store and
        the relay now hold).  ``return_master=False`` skips that copy."""
        self._check_grad(i, g)
        master, aux, buf = self._fetch_leaf(i)
        self._stepper.step_flat(master, g, aux, self.step_count)
        if not return_master:
            self._release_leaf(i, buf)
            return None
        # copy BEFORE release: an nvme write-back may recycle the buffer
        # the master view aliases into a later read-ahead
        out = master if buf is None else master.clone()
        self._release_leaf(i, buf)
        if self.int8_masters:
            return self._dequant_master(i)
        return out

    def step_leaf_bf16(self, i: int, g_bf16: torch.Tensor,
                       out_bf16: torch.Tensor) -> torch.Tensor:
        """Step one leaf from a flat bf16 grad, writing the updated params
        in bf16 straight into ``out_bf16``: ``ds_adam_step_bf16g`` (no fp32
        grad conversion, no separate downcast pass)."""
        if self.opt_type != "adam":
            raise RuntimeError("the bf16-grad step is Adam's")
        self._check_grad(i, g_bf16)
        if self.int8_masters:
            # the int8 store takes the fp32 path (its fetch/requant seam)
            master = self.step_leaf(i, g_bf16.float().reshape(-1))
            out_bf16.copy_(master.reshape(out_bf16.shape))
            return out_bf16
        master, aux, buf = self._fetch_leaf(i)
        self.adam.native_step_bf16g(master, g_bf16.reshape(-1),
                                    out_bf16.reshape(-1), aux[0], aux[1],
                                    self.step_count)
        self._release_leaf(i, buf)
        return out_bf16

    def end_step(self) -> None:
        if self.backend == "nvme":
            self._swapper.drain()

    def step(self, grads_host: List[torch.Tensor], lr: Optional[float] = None
             ) -> List[torch.Tensor]:
        """One optimizer step over all leaves (flat fp32 host grads, in
        tree-leaf order).  Returns the updated fp32 masters."""
        self.begin_step(lr=lr)
        out = [self.step_leaf(i, torch.as_tensor(grads_host[i]).to(
            torch.float32).contiguous().reshape(-1))
            for i in range(len(self._sizes))]
        self.end_step()
        return out

    # ------------------------------------------------------------------
    def masters(self) -> List[torch.Tensor]:
        """Current fp32 masters (read back from NVMe for the nvme backend;
        dequantized values of the int8 store under ``int8_masters``)."""
        if self.backend == "cpu" and self.int8_masters:
            return [self._dequant_master(i) for i in range(len(self._sizes))]
        if self.backend == "cpu":
            return self._master
        return [self._swapper.read_sync(i)[:self._sizes[i]].clone()
                for i in range(len(self._sizes))]

    def _leaf_states(self, i: int) -> List[torch.Tensor]:
        """[master, *aux] flat fp32 for leaf i (checkpoints stay fp32
        across int8_masters on/off: the int8 store requantizes losslessly
        on load, since dequantized values are exact multiples of their
        block scale)."""
        if self.backend == "cpu" and self.int8_masters:
            return [self._dequant_master(i)] + self._dequant_aux(i)
        if self.backend == "cpu":
            return [self._master[i]] + [a[i] for a in self._aux]
        buf = self._swapper.read_sync(i)
        sz = self._sizes[i]
        return [buf[k * sz:(k + 1) * sz] for k in range(1 + self.n_aux)]

    def _set_leaf_states(self, i: int, states: List[Any]) -> None:
        states = [_host_copy(s) for s in states]
        if self.backend == "cpu" and self.int8_masters:
            self._requant_leaf(i, states[0], states[1:])
        elif self.backend == "cpu":
            self._master[i].copy_(states[0])
            for a, s in zip(self._aux, states[1:]):
                a[i].copy_(s)
        else:
            self._swapper.write_sync(i, torch.cat(states))

    def set_master(self, i: int, value: Any) -> None:
        """Replace leaf ``i``'s fp32 master, its moments kept."""
        states = self._leaf_states(i)
        states = [s.clone() for s in states]
        states[0] = _host_copy(value)
        self._set_leaf_states(i, states)

    def state_dict(self) -> Dict[str, Any]:
        names = ("master",) + self.AUX_NAMES[self.opt_type]
        out: Dict[str, Any] = {name: [] for name in names}
        for i in range(len(self._sizes)):
            for name, t in zip(names, self._leaf_states(i)):
                out[name].append(t)
        out["step_count"] = int(self.step_count)
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        names = ("master",) + self.AUX_NAMES[self.opt_type]
        self.step_count = int(sd["step_count"])
        for i in range(len(self._sizes)):
            self._set_leaf_states(i, [sd[name][i] for name in names])

    def _full_sizes(self, places) -> List[int]:
        """Each leaf's whole size: its place's full shape, or its own."""
        if places is None:
            return [int(s) for s in self._sizes]
        return [int(np.prod(p[0])) if p is not None else int(s)
                for p, s in zip(places, self._sizes)]

    def _write_meta(self, dirpath: str, places=None) -> None:
        meta = {"step_count": int(self.step_count), "n": len(self._sizes),
                "sizes": self._full_sizes(places), "backend": self.backend,
                "opt_type": self.opt_type}
        with open(os.path.join(dirpath, "meta.json"), "w") as fh:
            json.dump(meta, fh)

    def create_state_files(self, dirpath: str, places) -> None:
        """Every ``leaf{i}.{name}.npy`` at the leaf's full size and
        ``meta.json``, for the ranks' :meth:`write_state` (``places``: a leaf
        ``(full shape, region)`` of this rank's slice, or None for a leaf
        held whole)."""
        os.makedirs(dirpath, exist_ok=True)
        names = ("master",) + self.AUX_NAMES[self.opt_type]
        for i, n in enumerate(self._full_sizes(places)):
            for name in names:
                np.lib.format.open_memmap(os.path.join(dirpath, f"leaf{i}.{name}.npy"),
                                          mode="w+", dtype=np.float32, shape=(n,)).flush()
        self._write_meta(dirpath, places)

    def write_state(self, dirpath: str, places=None, slices: bool = True,
                    whole: bool = True) -> None:
        """Stream the optimizer state to ``dirpath`` one leaf at a time, in
        the JAX package's layout: ``leaf{i}.{name}.npy`` (fp32, flat) and
        ``meta.json``.  With ``places`` the files exist at full size
        (:meth:`create_state_files`) and each leaf's slice is written into
        its region (``slices``), a leaf held whole whole (``whole``)."""
        os.makedirs(dirpath, exist_ok=True)
        names = ("master",) + self.AUX_NAMES[self.opt_type]
        for i in range(len(self._sizes)):
            place = places[i] if places is not None else None
            if places is not None and not (slices if place is not None else whole):
                continue
            for name, t in zip(names, self._leaf_states(i)):
                path = os.path.join(dirpath, f"leaf{i}.{name}.npy")
                if places is None:
                    np.save(path, t.numpy())
                    continue
                mm = np.load(path, mmap_mode="r+")
                if place is None:
                    mm[:] = t.numpy()
                else:
                    full, region = place
                    mm.reshape(full)[tuple(slice(a, b) for a, b in region)] = \
                        t.numpy().reshape([b - a for a, b in region])
                mm.flush()
                del mm
        if places is None:
            self._write_meta(dirpath)

    def read_state(self, dirpath: str, places=None) -> None:
        """The inverse of :meth:`write_state`, each leaf's region of its
        place (``places`` as there) read alone; raises on another leaf
        layout or optimizer type."""
        with open(os.path.join(dirpath, "meta.json")) as fh:
            meta = json.load(fh)
        if meta["sizes"] != self._full_sizes(places):
            raise ValueError(f"offload state shape mismatch in {dirpath}: "
                             f"{meta['sizes']} != {self._full_sizes(places)}")
        if meta.get("opt_type", "adam") != self.opt_type:
            raise ValueError(f"offload optimizer type mismatch in {dirpath}: "
                             f"{meta.get('opt_type', 'adam')} != {self.opt_type}")
        self.step_count = int(meta["step_count"])
        names = ("master",) + self.AUX_NAMES[self.opt_type]
        for i in range(len(self._sizes)):
            place = places[i] if places is not None else None
            states = []
            for name in names:
                path = os.path.join(dirpath, f"leaf{i}.{name}.npy")
                if place is None:
                    states.append(np.load(path))
                    continue
                full, region = place
                mm = np.load(path, mmap_mode="r")
                states.append(np.ascontiguousarray(
                    mm.reshape(full)[tuple(slice(a, b) for a, b in region)]))
                del mm
            self._set_leaf_states(i, states)
