"""Crash-atomic checkpoint layout: staging, manifests, the ``latest``
pointer, and the walk-back to the newest valid tag.

A copy of ``deepspeed_tpu/runtime/checkpoint_engine/atomic.py``: the same
layout, the same ``FORMAT_VERSION`` and the same manifest keys, so a tag
either package writes verifies and loads in the other.

A checkpoint interrupted mid-write must never be able to masquerade as a
valid restore point: for a long training run the checkpoint is the only
recovery path.  The contract:

- **Staging**: a save writes every file into ``<save_dir>/tmp.<tag>``.
  The ``tmp.`` prefix is the invariant: directory listings of valid tags
  (``list_tags``) never return staged dirs, so a kill at ANY byte offset
  during the write leaves only debris the next save clears.
- **Manifest**: ``MANIFEST.json`` records, per file, size + sha256 (plus
  world_size / zero_stage / format version).  It is written LAST inside
  the stage, after fsyncing every data file, so its presence certifies
  the stage was fully written.
- **Publish**: the stage is renamed into place (``os.rename`` — atomic on
  POSIX within a filesystem) and the parent directory fsynced.  Only then
  is the ``latest`` pointer updated, itself via tmp + ``os.replace``.
- **Verify**: ``verify_dir`` re-checks the manifest (existence + size,
  and checksums at ``level="full"``) before a load trusts the bytes.
  Directories without a manifest are reported as ``no_manifest`` — the
  caller decides whether to accept them (legacy checkpoints predate the
  manifest) or skip them.

Deliberately stdlib-only (no torch, no package-relative imports), as the
JAX package's copy, which its ``tools/ckpt_verify.py`` execs by path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1
TMP_PREFIX = "tmp."            # staged (uncommitted) checkpoint dirs
TRASH_PREFIX = ".trash."       # pre-publish rename target for a stale tag
LATEST_NAME = "latest"

__all__ = ["MANIFEST_NAME", "FORMAT_VERSION", "TMP_PREFIX", "TRASH_PREFIX",
           "LATEST_NAME", "CheckpointStatus", "sha256_file", "fsync_file",
           "fsync_dir", "stage_path", "write_manifest", "verify_dir",
           "deep_verify", "read_latest", "write_latest", "list_tags",
           "publish_dir", "clear_stage", "sweep_trash"]


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Flush a directory entry (rename/create durability).  Platforms that
    cannot fsync a directory fd (some network filesystems) degrade to a
    no-op — the rename ordering still holds, only its durability window
    widens."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def stage_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, TMP_PREFIX + str(tag))


def _walk_files(ckpt_dir: str) -> List[str]:
    """Relative paths ('/'-separated) of every file under ``ckpt_dir``,
    excluding the manifest itself; sorted for a stable manifest."""
    out = []
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), ckpt_dir)
            rel = rel.replace(os.sep, "/")
            if rel != MANIFEST_NAME:
                out.append(rel)
    return sorted(out)


def write_manifest(ckpt_dir: str, tag: str,
                   extra: Optional[Dict[str, Any]] = None,
                   fsync: bool = True) -> Dict[str, Any]:
    """Checksum every file in ``ckpt_dir`` and write ``MANIFEST.json``
    (tmp + ``os.replace``), fsyncing the data files first and the manifest
    and directory after — the stage is durable before it can be
    published."""
    files: Dict[str, Dict[str, Any]] = {}
    for rel in _walk_files(ckpt_dir):
        path = os.path.join(ckpt_dir, rel.replace("/", os.sep))
        if fsync:
            fsync_file(path)
        files[rel] = {"nbytes": os.path.getsize(path),
                      "sha256": sha256_file(path)}
    manifest = {"format_version": FORMAT_VERSION, "tag": str(tag),
                "time_unix": time.time(), "files": files}
    if extra:
        manifest.update(extra)
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True, default=str)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, mpath)
    if fsync:
        fsync_dir(ckpt_dir)
    return manifest


class CheckpointStatus:
    """Result of ``verify_dir``: ``state`` is one of ``valid`` /
    ``missing`` (no such directory) / ``no_manifest`` (pre-manifest
    layout — loadable but unverifiable) / ``corrupt`` (manifest present
    but contradicted by the bytes on disk)."""

    def __init__(self, state: str, problems: Optional[List[str]] = None,
                 manifest: Optional[Dict[str, Any]] = None):
        self.state = state
        self.problems = problems or []
        self.manifest = manifest

    @property
    def ok(self) -> bool:
        return self.state == "valid"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"CheckpointStatus({self.state!r}, problems={self.problems})"


def verify_dir(ckpt_dir: str, level: str = "full") -> CheckpointStatus:
    """Verify a checkpoint directory against its manifest.

    ``level="fast"`` checks existence + size only (retention GC);
    ``level="full"`` additionally re-hashes every file (load path,
    offline audit)."""
    if not os.path.isdir(ckpt_dir):
        return CheckpointStatus("missing", [f"no such directory: {ckpt_dir}"])
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return CheckpointStatus("no_manifest",
                                [f"no {MANIFEST_NAME} in {ckpt_dir}"])
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as exc:
        return CheckpointStatus("corrupt", [f"unreadable manifest: {exc}"])
    files = manifest.get("files")
    if not isinstance(files, dict):
        return CheckpointStatus("corrupt", ["manifest has no files map"],
                                manifest)
    problems: List[str] = []
    for rel, meta in sorted(files.items()):
        path = os.path.join(ckpt_dir, rel.replace("/", os.sep))
        if not os.path.exists(path):
            problems.append(f"missing file: {rel}")
            continue
        size = os.path.getsize(path)
        if size != int(meta.get("nbytes", -1)):
            problems.append(f"size mismatch: {rel} is {size}B, manifest "
                            f"says {meta.get('nbytes')}B")
            continue
        if level == "full" and meta.get("sha256"):
            got = sha256_file(path)
            if got != meta["sha256"]:
                problems.append(f"checksum mismatch: {rel}")
    if problems:
        return CheckpointStatus("corrupt", problems, manifest)
    return CheckpointStatus("valid", manifest=manifest)


def _sha256_range(path: str, offset: int, nbytes: int,
                  chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        fh.seek(offset)
        left = nbytes
        while left > 0:
            block = fh.read(min(chunk, left))
            if not block:
                break
            h.update(block)
            left -= len(block)
    return h.hexdigest()


def deep_verify(ckpt_dir: str) -> List[str]:
    """Chunk-level verification of the sharded payload layout.

    The manifest's per-file sha256 (``verify_dir(level="full")``) proves a
    file changed; this pass reads every ``index_p*.json`` under
    ``ckpt_dir`` and re-hashes each recorded CHUNK byte range against the
    per-chunk ``sha256`` the sharded writer stores, so a bit flip is
    reported with the offending shard path AND pytree leaf — and two
    structural checks corruption of the index itself would hide behind:
    chunk ranges must lie inside their bin file, and a leaf's chunks must
    cover exactly its global element count (missing shard files
    under-cover).  Returns a list of problem strings (empty = clean).
    Checkpoints written before per-chunk hashes verify structurally only.

    Stdlib-only on purpose, as the JAX package's copy."""
    problems: List[str] = []
    for root, _dirs, files in os.walk(ckpt_dir):
        idx_names = sorted(n for n in files
                           if n.startswith("index_p") and n.endswith(".json"))
        if not idx_names:
            continue
        sub = os.path.relpath(root, ckpt_dir).replace(os.sep, "/")
        sub = "" if sub == "." else sub + "/"
        sizes = {n: os.path.getsize(os.path.join(root, n))
                 for n in files if not n.endswith(".json")}
        # leaf -> [total chunk elements, total declared elements] across
        # ALL process indexes (a leaf's chunks may span writers)
        coverage: Dict[str, List[int]] = {}
        for idx_name in idx_names:
            try:
                with open(os.path.join(root, idx_name)) as fh:
                    index = json.load(fh)
            except (OSError, ValueError) as exc:
                problems.append(f"{sub}{idx_name}: unreadable index ({exc})")
                continue
            for key, meta in sorted(index.items()):
                shape = meta.get("shape", [])
                want = 1
                for d in shape:
                    want *= int(d)
                cov = coverage.setdefault(key, [0, want])
                for k, ch in enumerate(meta.get("chunks", [])):
                    where = f"{sub}{ch.get('file', '?')} leaf {key!r} chunk {k}"
                    elems = 1
                    for a, b in ch.get("index", []):
                        elems *= max(0, int(b) - int(a))
                    fsize = sizes.get(ch.get("file"))
                    off, nb = int(ch.get("offset", -1)), int(ch.get("nbytes", -1))
                    if fsize is None or off < 0 or nb < 0 or off + nb > fsize:
                        problems.append(
                            f"{where}: byte range [{off}, {off + nb}) "
                            f"outside shard file (size {fsize})")
                        continue
                    # only structurally-sound chunks count toward leaf
                    # coverage (a truncated/missing shard must surface as
                    # under-coverage, not silently "cover" its region)
                    cov[0] += elems
                    rec = ch.get("sha256")
                    if rec:
                        got = _sha256_range(os.path.join(root, ch["file"]),
                                            off, nb)
                        if got != rec:
                            problems.append(f"{where}: chunk checksum "
                                            f"mismatch")
        for key, (have, want) in sorted(coverage.items()):
            if have < want:
                problems.append(f"{sub}: leaf {key!r} under-covered "
                                f"({have} of {want} elements; missing "
                                f"shard files?)")
    return problems


def read_latest(save_dir: str) -> Optional[str]:
    path = os.path.join(save_dir, LATEST_NAME)
    try:
        with open(path) as fh:
            tag = fh.read().strip()
        return tag or None
    except OSError:
        return None


def write_latest(save_dir: str, tag: str) -> None:
    """Atomic ``latest`` update: tmp + fsync + ``os.replace`` + dir fsync.
    A crash leaves either the old pointer or the new one, never a torn
    write."""
    path = os.path.join(save_dir, LATEST_NAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(str(tag))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(save_dir)


def list_tags(save_dir: str) -> List[str]:
    """Published checkpoint tags in ``save_dir``, newest first.

    A tag is a non-hidden directory not carrying the ``tmp.`` stage
    prefix that looks like a checkpoint (has a manifest, or the legacy
    ``model_states`` payload).  Ordering key: manifest ``time_unix``,
    falling back to directory mtime for legacy tags."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        if name.startswith(TMP_PREFIX) or name.startswith("."):
            continue
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path):
            continue
        t = None
        mpath = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(mpath):
            try:
                with open(mpath) as fh:
                    t = float(json.load(fh).get("time_unix", 0.0))
            except (OSError, ValueError):
                t = None
        elif not any(n.startswith("model_states")
                     for n in os.listdir(path)):
            continue
        if t is None:
            t = os.path.getmtime(path)
        out.append((t, name))
    return [name for _t, name in sorted(out, reverse=True)]


def clear_stage(save_dir: str, tag: str) -> None:
    """Remove a stale staged dir and any renamed-aside ``.trash.`` copies
    of this tag (debris of a crashed earlier save/publish)."""
    stage = stage_path(save_dir, tag)
    if os.path.isdir(stage):
        shutil.rmtree(stage, ignore_errors=True)
    prefix = f"{TRASH_PREFIX}{tag}."
    try:
        names = os.listdir(save_dir)
    except OSError:
        return
    for name in names:
        if name.startswith(prefix):
            shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)


def sweep_trash(save_dir: str) -> List[str]:
    """Remove every ``.trash.*`` dir (a publish that crashed between
    rename-aside and cleanup leaks one, checkpoint-sized).  Returns the
    names removed.  Safe after a completed publish: a live publish deletes
    its own trash before returning."""
    removed = []
    try:
        names = os.listdir(save_dir)
    except OSError:
        return removed
    for name in names:
        if name.startswith(TRASH_PREFIX):
            shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
            removed.append(name)
    return removed


def publish_dir(stage_dir: str, final_dir: str) -> None:
    """Atomically rename the fully-written stage into place.

    Re-saving an existing tag cannot be atomic (POSIX rename refuses a
    non-empty target): the stale tag is first renamed aside to a hidden
    ``.trash.`` name — invisible to ``list_tags`` — so the worst crash
    window leaves the tag briefly ABSENT (the loader walks back), never
    half-overwritten."""
    trash = None
    if os.path.exists(final_dir):
        parent, name = os.path.split(final_dir)
        trash = os.path.join(parent, f"{TRASH_PREFIX}{name}.{os.getpid()}")
        os.rename(final_dir, trash)
    os.rename(stage_dir, final_dir)
    fsync_dir(os.path.dirname(final_dir) or ".")
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
