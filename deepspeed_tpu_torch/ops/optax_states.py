"""The optimizer states of the JAX package, as checkpoints lay them out.

A checkpoint's ``optim_states`` holds ``['opt_state']``: the state of the
optax transformation that ``build_optimizer``
(``deepspeed_tpu/runtime/optimizer.py``) makes for the ds_config, whose
leaf keys are ``jax.tree_util.keystr`` of its path.  The port's
optimizers give their state in that shape (``jax_state``), so their
checkpoints and the JAX package's load in either package:

- ``FusedAdamState`` / ``FusedLambState`` / ``Adam8bitState``: the fused
  transformations' own NamedTuples (``.count``, ``.m``, ...);
- optax's chains: a tuple with one state per link, ``ScaleByAdamState``
  for ``scale_by_adam``, ``ScaleByScheduleState`` for a schedule's
  learning rate and ``()`` (optax's ``EmptyState``, no leaf) for a link
  that keeps nothing, so ``optax.adamw`` under a schedule reads
  ``[0].count``, ``[0].mu``, ``[0].nu``, ``[2].count``;
- the chains of ``optax.lion`` (``ScaleByLionState``, decay, lr),
  ``optax.adagrad`` (``ScaleByRssState``, lr) and ``optax.sgd``
  (``TraceState``, lr), and the JAX package's ``MuonState(count,
  momentum)``.

Every ``count`` is the optimizer's one count, as an int32 scalar.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class ScaleByLionState(NamedTuple):
    count: Any
    mu: Any


class ScaleByRssState(NamedTuple):
    sum_of_squares: Any


class TraceState(NamedTuple):
    trace: Any


class MuonState(NamedTuple):
    """The JAX package's ``muon`` (``deepspeed_tpu/ops/adam/muon.py``)."""
    count: Any
    momentum: Any


EMPTY = ()


def count_leaf(count: int) -> torch.Tensor:
    return torch.tensor(int(count), dtype=torch.int32)


def lr_state(schedule, count: int):
    """optax's ``scale_by_learning_rate``: a schedule counts, a constant
    keeps nothing."""
    return ScaleByScheduleState(count_leaf(count)) if schedule else EMPTY
