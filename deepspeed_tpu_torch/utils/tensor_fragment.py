"""Parameter path names (the part of ``deepspeed_tpu/utils/
tensor_fragment.py`` the checkpoint tools use)."""

from __future__ import annotations


def _path_str(path) -> str:
    """A tree path as ``"layers/attn/wq"``: dict keys, sequence indices and
    attribute names joined by ``/``."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)
