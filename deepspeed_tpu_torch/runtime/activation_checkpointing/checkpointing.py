"""Activation checkpointing API, PyTorch port.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py``: the Megatron-compatible ``checkpoint()``,
``configure()`` and the RNG state tracker.

- ``checkpoint(fn, *args)`` is ``torch.utils.checkpoint.checkpoint``
  (non-reentrant): ``fn`` runs now and again in the backward.  The model's
  own remat policies (``ModelConfig.remat_policy``, set from the ds_config
  section by the engine, ``cpu_checkpointing`` among them) live in
  ``models/transformer.py``.
- Reproducible dropout under recompute is structural here, as in the JAX
  package: dropout draws from explicit threefry keys
  (:mod:`deepspeed_tpu_torch.utils.prng`) passed to the recomputed function
  as arguments, so the recompute draws the same masks by construction,
  with no ``torch.Generator`` state to save and restore.  The tracker is
  kept for API parity and manages named keys.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Dict, Optional

from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.utils import prng

logger = logging.getLogger(__name__)

_CONFIG: Dict[str, Any] = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,
    "number_checkpoints": None,
    "synchronize": False,
    "profile": False,
}


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None) -> None:
    """Reference entry point: record the subsystem config (the engine pushes
    the same section into the model's remat settings at init)."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing", None)
        if ac is not None:
            _CONFIG.update(
                partition_activations=ac.partition_activations,
                cpu_checkpointing=ac.cpu_checkpointing,
                contiguous_memory_optimization=getattr(
                    ac, "contiguous_memory_optimization", False),
                number_checkpoints=getattr(ac, "number_checkpoints", None))
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize", synchronize), ("profile", profile)):
        if val is not None:
            _CONFIG[key] = val
    logger.info("activation checkpointing configured: %s", _CONFIG)


def is_configured() -> bool:
    return True


def _check_policy(policy: Optional[Any]) -> None:
    if policy is not None:
        raise TypeError("checkpoint() here recomputes the whole function; "
                        "the saved-dots policies are the model's "
                        "remat_policy (models/transformer.py)")


def checkpoint(function: Callable, *args, policy: Optional[Any] = None):
    """Megatron-compatible ``checkpoint(fn, *args)``: runs ``fn`` now and
    recomputes it in the backward.  Dropout under recompute repeats itself
    when ``fn`` takes its keys as arguments."""
    _check_policy(policy)
    return _torch_checkpoint(function, *args, use_reentrant=False)


def checkpoint_wrapper(function: Callable, policy: Optional[Any] = None) -> Callable:
    """Decorator form used by model code."""
    _check_policy(policy)

    def wrapped(*args):
        return _torch_checkpoint(function, *args, use_reentrant=False)
    return wrapped


class CudaRNGStatesTracker:
    """API-parity RNG tracker: a registry of named threefry keys; ``fork``
    hands out a fresh split deterministically."""

    def __init__(self):
        self._states: Dict[str, prng.Key] = {}

    def reset(self) -> None:
        self._states.clear()

    def get_states(self):
        return dict(self._states)

    def set_states(self, states) -> None:
        self._states = dict(states)

    def add(self, name: str, seed: int) -> None:
        if name in self._states:
            raise Exception(f"seed {name} already exists")
        self._states[name] = prng.prng_key(seed)

    def fork(self, name: str = "model-parallel-rng"):
        @contextlib.contextmanager
        def _fork():
            if name not in self._states:
                raise Exception(f"seed {name} not added")
            self._states[name], sub = prng.split(self._states[name])
            yield sub

        return _fork()


_RNG_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker() -> CudaRNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed: int) -> None:
    """Reference parity: register the model-parallel dropout seed."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718)
