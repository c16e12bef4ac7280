"""Data loading, PyTorch port (counterpart of
``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` yields the JAX loader's sample stream (the same
permutation of ``np.random.default_rng(seed + epoch)``, ``drop_last``,
``collate_fn``) as CPU tensors; the engine moves a batch to its device.
Its ``batch_size`` is the global micro-batch (the micro batch times the
data-parallel world); at a data-parallel world of N, rank r yields rows
``[r * mb, (r + 1) * mb)`` of each global micro-batch, the rows device r
holds in the JAX loader's sharded batch, so the stream, its shuffle and
its resume state are the global ones on every rank.
Its ``state_dict`` (epoch, sample offset, shuffle identity) rides a
checkpoint's ``client_state`` so a resume replays the exact remaining
stream.  ``RepeatingLoader`` wraps it endlessly.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _stack(samples):
    """Stack per-sample trees (dicts, tuples, lists of arrays) leaf by leaf."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _to_torch(batch):
    """A host batch as CPU tensors (a tensor stays as it is)."""
    if isinstance(batch, dict):
        return {k: _to_torch(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_torch(x) for x in batch)
    if torch.is_tensor(batch):
        return batch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(batch)))


class DeepSpeedDataLoader:
    """Batched iteration over an in-memory dataset or torch-style dataset.

    ``dataset`` may be: a tuple/list of equal-length arrays (xs, ys, ...), a
    sequence of per-sample trees, or an object with ``__len__``/``__getitem__``.
    Yields micro-batches of ``batch_size`` samples as CPU tensors; with
    ``data_world`` > 1, this rank's ``batch_size // data_world`` rows of
    each (``data_rank``: its index over the data axes).
    """

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None, local_rank: int = 0,
                 data_sampler: Any = None, data_rank: int = 0,
                 data_world: int = 1):
        if batch_size % data_world:
            raise ValueError(f"global micro-batch {batch_size} does not split "
                             f"over a data-parallel world of {data_world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.data_rank = int(data_rank)
        self.data_world = int(data_world)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0
        self.data_sampler = data_sampler
        # the stream position in SAMPLES (not batches), so a resume at
        # another batch size replays the same remaining samples; the
        # permutation is a pure function of (seed, epoch).
        # ``_samples_consumed`` mirrors the live iterator (what state_dict
        # reports); ``_resume_offset`` is taken by exactly ONE __iter__
        # after load_state_dict, so a fresh iterator without a pending
        # resume starts the epoch at sample 0
        self._samples_consumed = 0
        self._resume_offset = 0

        if isinstance(dataset, (tuple, list)) and len(dataset) > 0 and hasattr(dataset[0], "shape"):
            self._arrays = tuple(np.asarray(a) for a in dataset)
            self._n = len(self._arrays[0])
        else:
            self._arrays = None
            self._n = len(dataset)

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._samples_consumed = 0
        self._resume_offset = 0

    # -- saveable stream state (rides checkpoints as client_state) -------
    def state_dict(self) -> dict:
        """Everything needed to resume the exact sample stream: epoch,
        sample offset within it, and the shuffle identity (seed + flag +
        dataset length, validated on restore)."""
        return {"epoch": int(self._epoch),
                "samples_consumed": int(self._samples_consumed),
                "seed": int(self.seed), "shuffle": bool(self.shuffle),
                "n": int(self._n)}

    def load_state_dict(self, sd: dict) -> None:
        """Restore a :meth:`state_dict`.  The permutation identity must
        match: a different dataset length or shuffle seed cannot replay the
        recorded stream, and resuming a different stream silently is worse
        than failing."""
        if int(sd.get("n", self._n)) != self._n:
            raise ValueError(
                f"dataloader resume: dataset length changed "
                f"({sd.get('n')} -> {self._n}); the saved sample offset "
                "indexes a different permutation")
        if bool(sd.get("shuffle", self.shuffle)) != self.shuffle:
            raise ValueError("dataloader resume: shuffle flag changed")
        if self.shuffle and int(sd.get("seed", self.seed)) != self.seed:
            raise ValueError(
                f"dataloader resume: shuffle seed changed "
                f"({sd.get('seed')} -> {self.seed})")
        self._epoch = int(sd.get("epoch", 0))
        self._samples_consumed = int(sd.get("samples_consumed", 0))
        self._resume_offset = self._samples_consumed

    def _perm(self) -> np.ndarray:
        idx = np.arange(self._n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Any]:
        idx = self._perm()
        # resume mid-epoch at the restored SAMPLE offset (taken by this one
        # iterator); from here the offset is the iterator's own
        start, self._resume_offset = self._resume_offset, 0
        self._samples_consumed = start
        avail = self._n - start
        nb = (avail // self.batch_size if self.drop_last
              else (avail + self.batch_size - 1) // self.batch_size)
        mb = self.batch_size // self.data_world
        for b in range(nb):
            lo = start + b * self.batch_size
            sel = idx[lo:lo + self.batch_size]
            consumed = lo + len(sel)
            sel = sel[self.data_rank * mb:(self.data_rank + 1) * mb]
            if self._arrays is not None:
                batch = tuple(a[sel] for a in self._arrays)
            else:
                samples = [self.dataset[int(i)] for i in sel]
                batch = (self.collate_fn(samples) if self.collate_fn is not None
                         else _stack(samples))
            # mirrored for state_dict (checkpoints taken mid-epoch)
            self._samples_consumed = consumed
            yield _to_torch(batch)
        self._epoch += 1
        self._samples_consumed = 0


class RepeatingLoader:
    """Endless wrapper (reference: ``RepeatingLoader``)."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    # stream-state passthrough: a repeating wrapper checkpoints and restores
    # its inner loader's position (restore re-enters at the saved offset)
    def state_dict(self) -> dict:
        return self.loader.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.loader.load_state_dict(sd)
        self._it = iter(self.loader)
