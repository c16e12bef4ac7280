"""The port's ``comm`` façade over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm/comm.py``).

The JAX package names its collectives after the reference's
(``init_distributed``, ``get_rank``, ``all_reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``barrier``, ``new_group``) and runs
them as XLA collectives over named mesh axes inside ``jit``.  The port
keeps the names and runs them eagerly on process groups: NCCL for a CUDA
device, gloo for the CPU.

- :func:`init_distributed` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes
  an explicit ``store``.  A world of one with no address gets an
  in-process ``HashStore``: no socket, no network.
- A collective's ``axis`` is a mesh axis name or a tuple of them (resolved
  through the global mesh of :mod:`.mesh` into that axis's process group),
  a ``ProcessGroup``, or None for the whole world.  Every call runs the
  collective, also over a group of one: nothing short-circuits at world 1.
- ``all_reduce`` and ``broadcast`` work in place and return the tensor;
  ``all_gather`` concatenates the members' tensors along ``gather_dim``
  (the JAX ``tiled=True``); ``reduce_scatter`` sums them and returns this
  member's slice along ``scatter_dim``; ``all_to_all_single`` sends slice
  j along ``split_dim`` to member j and concatenates what it receives
  along ``concat_dim``; ``all_reduce_grad`` is a sum that autograd
  differentiates.
- ``all_reduce``, ``all_gather`` and ``reduce_scatter`` take
  ``async_op=True``: the collective is issued (on NCCL, on its own stream
  after the work queued so far) and a :class:`Pending` comes back, whose
  ``wait()`` returns the result (on the card, making the current stream
  wait for it without blocking the host).  Inside :func:`coalescing` the
  async collectives of one kind over one group go out together at the
  block's end, each still its own collective (NCCL runs them as one
  group launch), and waiting for any of them waits for all.  The overlap
  schedule (``runtime/zero/overlap.py``) gathers a bucket ahead and
  reduces a bucket's grads while the backward goes on this way.
- Every call adds to a per-op counter of calls and bytes
  (:func:`counters`, :func:`reset_counters`, :func:`log_summary`): the bytes
  of the tensor a member sends, for ``all_gather`` the gathered output.
- A quantized collective (:mod:`.collectives_q`) also records itself once
  (:func:`record_q`, read by :func:`q_counters`; the JAX package's
  ``CommMetrics.record_q``): the bytes by dtype of the int8 codes and fp32
  scales it sends, and the dense twin, the bytes the dense collective
  would have moved (``ds_comm_<op>_dense_bytes_total``).  Its exchanges
  count in :func:`counters` as the collectives they are.

With no process group the queries answer rank 0 and world 1, as the JAX
functions do in one process.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# torch 2.13 renames the tensor collectives; the older names are what the
# card's torch has, so they are kept and their notice is silenced
warnings.filterwarnings(
    "ignore", message=r"`torch\.distributed\.(all_gather_into_tensor|"
    r"reduce_scatter_tensor)` is deprecated")

ReduceOp = type("ReduceOp", (), {"SUM": "sum", "AVG": "avg", "MAX": "max",
                                 "MIN": "min", "PRODUCT": "prod"})
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}

_COUNTS: Dict[str, List[int]] = {}     # op -> [calls, bytes]
_QCOUNTS: Dict[str, Dict[str, Any]] = {}   # quantized op -> its record
_VERBOSE = False

AxisLike = Union[None, str, Sequence[str], Any]


def _discover_scheduler_env(auto_mpi_discovery: bool) -> None:
    """mpirun / srun rank variables onto ``RANK`` / ``WORLD_SIZE`` (the JAX
    function's rule: only when asked, or under ``DS_AUTO_MPI_DISCOVERY``)."""
    if not (auto_mpi_discovery or os.environ.get("DS_AUTO_MPI_DISCOVERY")):
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return
    for rank_key, size_key in (("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
                               ("PMI_RANK", "PMI_SIZE"),
                               ("SLURM_PROCID", "SLURM_NTASKS")):
        if rank_key in os.environ and size_key in os.environ:
            os.environ.setdefault("RANK", os.environ[rank_key])
            os.environ.setdefault("WORLD_SIZE", os.environ[size_key])
            return


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = False,
                     distributed_port: int = 29500, verbose: bool = True,
                     timeout: datetime.timedelta = datetime.timedelta(minutes=30),
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config: Optional[Any] = None, rank: int = -1,
                     world_size: int = -1, *, device: Any = None,
                     store: Optional[Any] = None) -> None:
    """Join (or start) the default process group.

    ``rank`` and ``world_size`` come from the environment torchrun sets,
    else from the arguments, else 0 and 1.  The backend is
    ``dist_backend``, else ``gloo`` for ``device="cpu"`` and ``nccl`` for
    the card (``cuda:LOCAL_RANK`` becomes the current device).  The
    rendezvous is ``store`` when given, else ``init_method``, else
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT`` defaulting to
    ``distributed_port``), else for a world of one an in-process store.
    With ``config`` (a port ``DeepSpeedConfig``) its mesh section becomes
    the global mesh.  A second call only sets the mesh."""
    if not is_initialized():
        _discover_scheduler_env(auto_mpi_discovery)
        env_rank = os.environ.get("RANK")
        env_world = os.environ.get("WORLD_SIZE")
        rank = int(env_rank) if env_rank is not None else max(rank, 0)
        world = (int(env_world) if env_world is not None
                 else (world_size if world_size > 0 else 1))
        dev = torch.device(device) if device is not None else torch.device("cuda")
        backend = dist_backend or ("gloo" if dev.type == "cpu" else "nccl")
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("init_distributed: the nccl backend needs a "
                                   "CUDA device; pass device='cpu' for gloo")
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else get_local_rank())
        kwargs: Dict[str, Any] = {"backend": backend, "rank": rank,
                                  "world_size": world, "timeout": timeout}
        if store is not None:
            kwargs["store"] = store
        elif init_method is not None:
            kwargs["init_method"] = init_method
        elif world == 1 and "MASTER_ADDR" not in os.environ:
            kwargs["store"] = dist.HashStore()
        else:
            os.environ.setdefault("MASTER_PORT", str(distributed_port))
            kwargs["init_method"] = "env://"
        dist.init_process_group(**kwargs)
        if verbose:
            logger.info("init_distributed: backend=%s rank=%d world=%d",
                        backend, rank, world)
    if config is not None and getattr(config, "mesh", None) is not None:
        from deepspeed_tpu_torch.comm.mesh import mesh_from_config, set_global_mesh

        set_global_mesh(mesh_from_config(config.mesh))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy() -> None:
    """Leave the default process group (and drop the global mesh)."""
    from deepspeed_tpu_torch.comm.mesh import set_global_mesh

    set_global_mesh(None)
    if is_initialized():
        dist.destroy_process_group()


def get_rank(group: Any = None) -> int:
    """This process's rank; in ``group``, its place there (-1 when it is
    not a member)."""
    if not is_initialized():
        return 0
    return dist.get_rank() if group is None else dist.get_rank(group)


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_world_size(group: Any = None) -> int:
    if not is_initialized():
        return 1
    return dist.get_world_size() if group is None else dist.get_world_size(group)


def get_process_count() -> int:
    return get_world_size()


def _group(axis: AxisLike):
    """The process group of a mesh axis name (or tuple of names), a group
    as it is, None for the world."""
    if axis is None:
        return None
    if isinstance(axis, str) or (isinstance(axis, (tuple, list))
                                 and all(isinstance(a, str) for a in axis)):
        from deepspeed_tpu_torch.comm.mesh import get_global_mesh

        return get_global_mesh().group(axis)
    return axis


def _count(op: str, nbytes: int) -> None:
    c = _COUNTS.setdefault(op, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)
    if _VERBOSE:
        logger.info("comm %s: %d bytes", op, nbytes)


def counters() -> Dict[str, Dict[str, int]]:
    """``{op: {"calls": n, "bytes": b}}`` since the last reset."""
    return {op: {"calls": c[0], "bytes": c[1]} for op, c in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()
    _QCOUNTS.clear()


def _dtype_name(t: Any) -> str:
    return str(getattr(t, "dtype", "")).replace("torch.", "")


def record_q(op: str, parts: Sequence[Any], dense_like: Any) -> None:
    """One call of a quantized collective: ``parts`` the tensors it sends
    (codes and scales; their bytes by dtype), ``dense_like`` the tensor
    (or anything with ``shape`` and ``dtype``) the dense collective would
    have sent, whose bytes are the dense twin."""
    def nb(a) -> int:
        n = 1
        for d in getattr(a, "shape", ()):
            n *= int(d)
        return n * torch.empty((), dtype=a.dtype).element_size()

    rec = _QCOUNTS.setdefault(op, {"calls": 0, "bytes": {}, "dense_bytes": 0,
                                   "dense_dtype": _dtype_name(dense_like)})
    rec["calls"] += 1
    for p in parts:
        if p is not None:
            key = _dtype_name(p)
            rec["bytes"][key] = rec["bytes"].get(key, 0) + nb(p)
    rec["dense_bytes"] += nb(dense_like)
    if _VERBOSE:
        logger.info("comm %s: %s bytes, dense twin %d", op, rec["bytes"],
                    rec["dense_bytes"])


def q_counters() -> Dict[str, Dict[str, Any]]:
    """``{op: {"calls", "bytes": {dtype: b}, "dense_bytes", "dense_dtype"}}``
    of the quantized collectives since the last reset."""
    return {op: dict(r, bytes=dict(r["bytes"])) for op, r in _QCOUNTS.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Pending:
    """An issued collective: :meth:`wait` waits for it and returns its
    result."""

    def __init__(self, work, finish, keep=()):
        # ``keep``: the tensors the collective reads, alive until it is done
        self._work, self._finish, self._keep = work, finish, keep

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._finish()


class _Batch:
    """The collectives of a :func:`coalescing` block: one wait for all,
    once the block has issued them."""

    def __init__(self):
        self._cm = None
        self._done = False

    def wait(self) -> None:
        if not self._done:
            self._cm.wait()
            self._done = True


_BATCH: Optional[_Batch] = None


@contextlib.contextmanager
def coalescing(axis: AxisLike = None):
    """Issue the async collectives of the block over ``axis`` together:
    they must be of one kind (all gathers, all reduce-scatters or all
    sums); each one's :class:`Pending` waits for the whole batch."""
    global _BATCH
    if _BATCH is not None:
        raise RuntimeError("comm.coalescing blocks do not nest")
    group = _group(axis)
    batch = _Batch()
    _BATCH = batch
    try:
        with dist.distributed_c10d._coalescing_manager(group=group,
                                                       async_ops=True) as cm:
            yield batch
    finally:
        _BATCH = None
    batch._cm = cm


def _work(work, async_op: bool):
    """The handle an async collective's :class:`Pending` waits on: its own,
    or its :func:`coalescing` block's."""
    if async_op and _BATCH is not None:
        return _BATCH
    return work


def all_reduce(x: torch.Tensor, axis: AxisLike = ("dp", "fsdp"),
               op: str = "sum", async_op: bool = False):
    """Reduce ``x`` in place over ``axis`` (``sum``, ``avg``, ``max``,
    ``min``, ``prod``; ``avg`` is a sum divided by the group's size, which
    gloo has no op for); returns ``x`` (a :class:`Pending` of it with
    ``async_op``)."""
    group = _group(axis)
    _count("all_reduce", _nbytes(x))
    avg = op in ("avg", ReduceOp.AVG)
    if not avg and op not in _OPS:
        raise ValueError(f"unsupported reduce op {op}")
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM if avg else _OPS[op],
                           group=group, async_op=async_op)

    def finish():
        return x.div_(get_world_size(group)) if avg else x
    return Pending(_work(work, async_op), finish) if async_op else finish()


def all_reduce_grad(x: torch.Tensor, axis: AxisLike = ("dp", "fsdp")) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` as a new tensor that autograd
    differentiates: its backward sums the grads over the group."""
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    group = _group(axis)
    _count("all_reduce", _nbytes(x))
    return _all_reduce(x, group=group if group is not None else dist.group.WORLD)


def all_gather(x: torch.Tensor, axis: AxisLike, gather_dim: int = 0,
               tiled: bool = True, out: Optional[torch.Tensor] = None,
               async_op: bool = False):
    """The members' ``x`` in rank order, concatenated along ``gather_dim``
    (``tiled``) or stacked on a new one; into ``out`` when given (a
    :class:`Pending` of it with ``async_op``)."""
    group = _group(axis)
    n = get_world_size(group)
    x = x.contiguous()
    direct = (tiled and gather_dim == 0 and out is not None
              and out.is_contiguous() and out.dtype == x.dtype)
    buf = out if direct else torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                         device=x.device)
    _count("all_gather", n * _nbytes(x))
    work = dist.all_gather_into_tensor(buf.view(-1), x.view(-1), group=group,
                                       async_op=async_op)

    def finish():
        if direct:
            return out
        full = buf.movedim(0, gather_dim)
        if tiled:
            shape = list(x.shape)
            shape[gather_dim] *= n
            full = full.reshape(shape)
        if out is None:
            return full.contiguous()
        return out.copy_(full)
    return Pending(_work(work, async_op), finish, (x,)) if async_op else finish()


def reduce_scatter(x: torch.Tensor, axis: AxisLike, scatter_dim: int = 0,
                   async_op: bool = False):
    """The sum of the members' ``x``, split along ``scatter_dim`` into as
    many equal slices as members: this member's slice (a :class:`Pending`
    of it with ``async_op``)."""
    group = _group(axis)
    n = get_world_size(group)
    if x.shape[scatter_dim] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    send = (x.contiguous() if scatter_dim == 0 or n == 1
            else torch.stack(x.chunk(n, scatter_dim)))
    shape = list(x.shape)
    shape[scatter_dim] //= n
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _count("reduce_scatter", _nbytes(x))
    work = dist.reduce_scatter_tensor(out.view(-1), send.view(-1), group=group,
                                      async_op=async_op)
    return Pending(_work(work, async_op), lambda: out, (send,)) if async_op else out


def all_to_all_single(x: torch.Tensor, axis: AxisLike, split_dim: int = 0,
                      concat_dim: int = 0, quantized: bool = False,
                      quant_block: int = 256) -> torch.Tensor:
    """``x`` split along ``split_dim`` into as many slices as members,
    slice j sent to member j; the slices received concatenated along
    ``concat_dim`` in rank order (the JAX ``tiled`` all_to_all).
    ``quantized`` (the ``comm_quantization.all_to_all`` site) sends each
    slice as blockwise int8 codes and fp32 scales
    (:func:`~deepspeed_tpu_torch.comm.collectives_q.q_all_to_all`)."""
    if quantized:
        from deepspeed_tpu_torch.comm.collectives_q import q_all_to_all

        return q_all_to_all(x, axis, split_dim, concat_dim, block=quant_block)
    group = _group(axis)
    n = get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all_single: dim {split_dim} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    send = (x.contiguous() if split_dim == 0 or n == 1
            else torch.stack(x.chunk(n, split_dim)))
    piece = list(x.shape)
    piece[split_dim] //= n
    recv = torch.empty([n] + piece, dtype=x.dtype, device=x.device)
    _count("all_to_all", _nbytes(x))
    dist.all_to_all_single(recv.view(-1), send.view(-1), group=group)
    if n == 1:
        return recv[0]
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


def new_group(ranks: Sequence[int], backend: Optional[str] = None):
    """A process group over ``ranks`` (every rank of the world calls it)."""
    return dist.new_group(list(ranks), backend=backend)


def barrier(group: Any = None) -> None:
    if is_initialized():
        _count("barrier", 0)
        dist.barrier(group=group)


def broadcast(x: torch.Tensor, src: int = 0, group: Any = None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every member, in place."""
    if is_initialized():
        _count("broadcast", _nbytes(x))
        dist.broadcast(x, src=src, group=group)
    return x


def broadcast_object_list(objects: List[Any], src: int = 0,
                          group: Any = None) -> List[Any]:
    """Picklable objects from ``src`` into ``objects`` on every rank."""
    if is_initialized():
        _count("broadcast_object", 0)
        dist.broadcast_object_list(objects, src=src, group=group)
    return objects


def log_summary() -> str:
    """The counters as a table (and logged); a quantized op's row gives its
    wire bytes and its dense twin."""
    lines = [f"{'op':<18}{'calls':>10}{'bytes':>18}"]
    for op, c in sorted(_COUNTS.items()):
        lines.append(f"{op:<18}{c[0]:>10}{c[1]:>18}")
    for op, r in sorted(_QCOUNTS.items()):
        lines.append(f"{op:<18}{r['calls']:>10}{sum(r['bytes'].values()):>18}"
                     f"  (dense {r['dense_bytes']})")
    text = "\n".join(lines)
    logger.info("comm summary:\n%s", text)
    return text


def configure(deepspeed_config=None, verbose: Optional[bool] = None,
              **kwargs) -> None:
    """``verbose`` (or the config's ``comms_logger.verbose``) logs every
    collective; the counters always run."""
    global _VERBOSE
    if verbose is not None:
        _VERBOSE = bool(verbose)
    elif deepspeed_config is not None:
        sec = getattr(deepspeed_config, "_param_dict", {}).get("comms_logger") or {}
        _VERBOSE = bool(sec.get("verbose", False)) or _VERBOSE
