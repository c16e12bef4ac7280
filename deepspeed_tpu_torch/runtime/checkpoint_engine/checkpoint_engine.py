"""Checkpoint engine ABC (counterpart of ``deepspeed_tpu/runtime/
checkpoint_engine/checkpoint_engine.py``).

The JAX package's ``MsgpackCheckpointEngine`` serializes with flax, which
the port does not have; the pre-sharded msgpack layout it reads is refused
where a load meets it (ROADMAP.md queue 1: the legacy msgpack layout).
"""

from __future__ import annotations

import abc
import logging
from typing import Any

logger = logging.getLogger(__name__)


class CheckpointEngine(abc.ABC):
    """Save/load backend contract (reference: ``CheckpointEngine`` ABC)."""

    def __init__(self, config_params: Any = None):
        self.config_params = config_params

    def create(self, tag: str) -> None:
        logger.info("checkpoint: starting tag %s", tag)

    @abc.abstractmethod
    def save(self, state_dict: Any, path: str) -> None: ...

    @abc.abstractmethod
    def load(self, path: str, target: Any = None) -> Any: ...

    def commit(self, tag: str) -> bool:
        logger.info("checkpoint: committed tag %s", tag)
        return True
