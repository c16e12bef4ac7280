"""Sharded checkpoint engine over torch tensors (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/sharded.py``).

The layout is the JAX package's, byte for byte, so either package loads
the other's tags:

- ``shard_p{N}.bin`` holds the raw bytes of every leaf, one after the
  other; ``index_p{N}.json`` records, per leaf, its global shape, its dtype
  (numpy's name; ``"bfloat16"`` for torch's bf16, written and read as raw
  2-byte words) and its chunks (global slice -> file, offset, nbytes,
  sha256).  A leaf's key is the string ``jax.tree_util.keystr`` gives its
  path in the saved tree: ``['k']`` for a dict key, ``[i]`` for a sequence
  index, ``.name`` for a NamedTuple field (:func:`keystr`).
- **Save streams** one leaf at a time, device -> host -> file: the peak
  host buffer is the largest leaf, never the tree.  Process ``N`` writes
  ``shard_p{N}.bin``: a whole leaf as one chunk ``[[0, d], ...]`` (on one
  process only, as the JAX engine writes a replicated leaf once), a ZeRO
  shard as the chunk of its region of the global leaf; a leaf another
  process writes is in the index with no chunk.
- **Load assembles** each leaf from every chunk recorded for it, through
  ``np.memmap`` of the byte ranges it needs, so a tag the JAX engine wrote
  from a many-device mesh (many chunks a leaf, across process files) loads
  whole.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine

BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# tree paths, as jax.tree_util names them
# ---------------------------------------------------------------------------

class DictKey:
    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class SequenceKey:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __str__(self) -> str:
        return f"[{self.idx}]"


class GetAttrKey:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __str__(self) -> str:
        return f".{self.name}"


def tree_flatten_with_path(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree_util``'s order: a dict's keys
    sorted, a NamedTuple's fields and a list's or tuple's items in order;
    ``None`` and an empty tuple (optax's ``EmptyState``) hold no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], path + (DictKey(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for name in tree._fields
                for x in tree_flatten_with_path(getattr(tree, name),
                                                path + (GetAttrKey(name),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v, path + (SequenceKey(i),))]
    return [(path, tree)]


def tree_map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path`` over the structures
    :func:`tree_flatten_with_path` walks."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (DictKey(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, n),
                                               path + (GetAttrKey(n),))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (SequenceKey(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path."""
    return "".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# leaves <-> bytes
# ---------------------------------------------------------------------------

def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """One leaf on the host as a C-contiguous array, and its dtype name.
    bf16 travels as its raw 2-byte words."""
    name = None
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t, name = t.view(torch.int16), BF16
        arr = t.cpu().numpy()
    else:
        # NB: np.ascontiguousarray would promote a 0-d array to (1,)
        arr = np.require(np.asarray(leaf), requirements="C")
    return arr, name or str(arr.dtype)


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype the bytes of a leaf are read as (bf16: int16 words)."""
    if name == BF16:
        return np.dtype(np.int16)
    return np.dtype(name)


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == BF16 else t


def _sha256(buf) -> str:
    return hashlib.sha256(buf).hexdigest()


class ShardedCheckpointEngine(CheckpointEngine):
    """``shard_p0.bin`` + ``index_p0.json`` per directory; loads read any
    number of chunks and process files."""

    def __init__(self, config_params: Any = None):
        super().__init__(config_params)
        self.max_bytes_in_flight = 0  # peak single host buffer, for tests

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, state_dict: Any, path: str, proc: int = 0,
             shards: Optional[Dict[int, Tuple[Tuple[int, ...], List[List[int]]]]] = None,
             write_whole: bool = True, write_shards: bool = True) -> None:
        """Write every leaf of ``state_dict`` (tensors on any device,
        numpy arrays or Python scalars, in dicts, lists, tuples and
        NamedTuples) into ``shard_p{proc}.bin``: one leaf on the host at a
        time, its sha256 taken on a second thread while it is written.
        ``shards`` maps ``id(leaf)`` of a ZeRO shard to the global leaf's
        shape and the shard's region; shards are written when
        ``write_shards``, whole leaves when ``write_whole``."""
        os.makedirs(path, exist_ok=True)
        shards = shards or {}
        index: Dict[str, Any] = {}
        bin_name = f"shard_p{proc}.bin"
        bin_path = os.path.join(path, bin_name)
        offset = 0
        with open(bin_path + ".tmp", "wb") as fh, \
                ThreadPoolExecutor(1) as hasher:
            for kp, leaf in tree_flatten_with_path(state_dict):
                placed = shards.get(id(leaf))
                arr, dtype = _host_array(leaf)
                shape = list(placed[0]) if placed else list(arr.shape)
                region = placed[1] if placed else [[0, d] for d in arr.shape]
                chunks = []
                if write_shards if placed else write_whole:
                    self.max_bytes_in_flight = max(self.max_bytes_in_flight,
                                                   arr.nbytes)
                    buf = memoryview(arr.reshape(-1)).cast("B")
                    digest = hasher.submit(_sha256, buf)
                    fh.write(buf)
                    # per-CHUNK sha256: a deep verification names the leaf
                    chunks.append({"index": region, "file": bin_name,
                                   "offset": offset, "nbytes": int(arr.nbytes),
                                   "sha256": digest.result()})
                    offset += arr.nbytes
                index[keystr(kp)] = {"shape": shape, "dtype": dtype,
                                     "chunks": chunks}
        os.replace(bin_path + ".tmp", bin_path)
        idx_path = os.path.join(path, f"index_p{proc}.json")
        with open(idx_path + ".tmp", "w") as fh:
            json.dump(index, fh)
        os.replace(idx_path + ".tmp", idx_path)

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    @staticmethod
    def read_index(path: str) -> Dict[str, Any]:
        """Union of all per-process indexes (chunk lists concatenate)."""
        merged: Dict[str, Any] = {}
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("index_p") and n.endswith(".json"))
        if not names:
            raise FileNotFoundError(f"no index_p*.json in {path}")
        for name in names:
            with open(os.path.join(path, name)) as fh:
                part = json.load(fh)
            for key, meta in part.items():
                if key in merged:
                    merged[key]["chunks"].extend(meta["chunks"])
                else:
                    merged[key] = meta
        return merged

    @staticmethod
    def _read_region(path: str, meta: Dict[str, Any], region: List[List[int]]
                     ) -> np.ndarray:
        """Assemble one global region from the stored chunks (reads only
        intersecting byte ranges via memmap)."""
        dtype = _np_dtype(meta["dtype"])
        shape = tuple(b - a for a, b in region)
        out = np.zeros(shape, dtype)
        covered = 0
        for ch in meta["chunks"]:
            cidx = ch["index"]
            inter = [(max(a0, b0), min(a1, b1))
                     for (a0, a1), (b0, b1) in zip(cidx, region)]
            if any(lo >= hi for lo, hi in inter):
                continue
            cshape = tuple(b - a for a, b in cidx)
            mm = np.memmap(os.path.join(path, ch["file"]), dtype=dtype,
                           mode="r", offset=ch["offset"],
                           shape=cshape if cshape else (1,))
            src = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(inter, cidx))
            dst = tuple(slice(lo - b, hi - b)
                        for (lo, hi), (b, _) in zip(inter, region))
            if cshape:
                out[dst] = mm[src]
            else:
                out = np.array(mm[0], dtype=dtype).reshape(())
            del mm
            covered += int(np.prod([hi - lo for lo, hi in inter])) if cshape else 1
        want = int(np.prod(shape)) if shape else 1
        if covered < want:
            raise ValueError(f"checkpoint region under-covered: have {covered} "
                             f"of {want} elements (missing shard files?)")
        return out

    def read_leaf(self, path: str, meta: Dict[str, Any],
                  region: Optional[List[List[int]]] = None) -> torch.Tensor:
        """One whole leaf, or its ``region`` (``[[start, stop], ...]`` a
        dim), as a CPU tensor of its saved dtype; only the byte ranges of
        the chunks that meet it are read."""
        if region is None:
            region = [[0, d] for d in meta["shape"]]
        return _to_tensor(self._read_region(path, meta, region), meta["dtype"])

    def load(self, path: str, target: Any = None) -> Any:
        """Load a sharded checkpoint directory: a flat ``{keystr: tensor}``
        dict of CPU tensors, or, with ``target`` (a tree), a tree of the
        same structure whose leaves are the saved tensors at its keys."""
        index = self.read_index(path)
        if target is None:
            return {key: self.read_leaf(path, meta) for key, meta in index.items()}

        def leaf(kp, _):
            key = keystr(kp)
            if key not in index:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            return self.read_leaf(path, index[key])
        return tree_map_with_path(leaf, target)


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and any(
        n.startswith("index_p") for n in os.listdir(path))


_KEY_SEG = re.compile(
    r"\[<flat index (\d+)>\]|\[(?:'([^']*)'|(\d+))\]|\.([A-Za-z_]\w*)")


def nest_keystrs(flat: Dict[str, Any]) -> Dict[Any, Any]:
    """{"['a'][0].count": v} -> {"a": {0: {"count": v}}}.

    Handles every jax keystr segment form: DictKey ``['k']``, SequenceKey
    ``[0]``, GetAttrKey ``.name`` (namedtuples in optimizer states), and
    FlattenedIndexKey ``[<flat index 0>]``.  The tools (zero_to_fp32, the
    universal checkpoint, the inference engine's load) use this to re-nest
    the flat index keys into a tree-shaped dict without knowing the
    original structure."""
    out: Dict[Any, Any] = {}
    for key, val in flat.items():
        segs: List[Any] = []
        for m in _KEY_SEG.finditer(key):
            flat_idx, dkey, seq_idx, attr = m.groups()
            if flat_idx is not None:
                segs.append(int(flat_idx))
            elif dkey is not None:
                segs.append(dkey)
            elif seq_idx is not None:
                segs.append(int(seq_idx))
            else:
                segs.append(attr)
        if not segs:
            segs = [key]
        cur = out
        for s in segs[:-1]:
            cur = cur.setdefault(s, {})
        cur[segs[-1]] = val
    return out

