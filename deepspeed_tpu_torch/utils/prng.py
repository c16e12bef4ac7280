"""The threefry-2x32 key chain of ``jax.random``, on the host and in torch.

The port's counterpart of the parts of ``jax.random`` that the JAX
package's dropout and MoE paths call (``PRNGKey``, ``split``,
``fold_in``, ``bernoulli``, ``permutation``), so that the port draws the
same masks and permutations from the same seed, bit for bit.  They follow
jax's default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the default since jax 0.5):

- a key is a pair of uint32 words, held on the host as Python ints;
  ``prng_key(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``split(key, n)[i]`` is the hash of the 64-bit counter ``i`` (its high
  and low words) under ``key``;
- ``fold_in(key, d)`` is the hash of the counter ``d``;
- the 32-bit draws of a shape are ``x0 ^ x1`` of the hash of each
  element's row-major flat index;
- a uniform in [0, 1) keeps the top 23 bits as a mantissa: ``u = (bits >>
  9) * 2**-23``, and ``bernoulli(key, p)`` is ``u < float32(p)``;
- ``permutation(key, n)`` sorts ``arange(n)`` stably by fresh 32-bit
  draws, ``ceil(3 ln n / ln(2**32 - 1))`` times, splitting the key before
  each round.

The hash is Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011): each round adds the second word to
the first, rotates the second left and xors the first into it, by the
rotations (13, 15, 26, 6) then (17, 29, 16, 24) in alternating groups of
four; the key words, extended by ``k2 = k0 ^ k1 ^ 0x1BD11BDA``, are added
before the first round and after every fourth, the ``s``-th injection also
adding ``s`` to the second word.

The hash takes Python ints (a key's few hashes, on the host) or int64
tensors masked to 32 bits on any device (the draws of a shape), since
torch's uint32 has few operations.  The dropout kernel
(``csrc/dropout.cu``) computes the same hash in registers.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under ``key``: Python ints, or int64 tensors holding uint32 values."""
    ks = (key[0] & MASK, key[1] & MASK, (key[0] ^ key[1] ^ PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for s in range(1, 6):
        for r in ROTATIONS[(s - 1) % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[s % 3]) & MASK
        x1 = (x1 + ((ks[(s + 1) % 3] + s) & MASK)) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return ((seed >> 32) & MASK, seed & MASK)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: ``num`` keys."""
    return [threefry2x32(key, i >> 32, i & MASK) for i in range(int(num))]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key, 0, int(data) & MASK)


def random_bits(key: Key, shape: Sequence[int],
                device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, idx >> 32, idx & MASK)
    return (x0 ^ x1).reshape(shape)


def keep_threshold(p: float) -> int:
    """The draws ``bits >> 9`` below which ``uniform < float32(p)``: ``u =
    (bits >> 9) * 2**-23`` is exact, so ``u < p`` is ``bits >> 9 <
    ceil(p * 2**23)``."""
    return int(math.ceil(float(np.float32(p)) * (1 << 23)))


def bernoulli(key: Key, p: float, shape: Sequence[int],
              device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a bool
    tensor."""
    return (random_bits(key, shape, device) >> 9) < keep_threshold(p)


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: an int64 [n] permutation."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(random_bits(sub, (n,), device), stable=True)
        x = x[order]
    return x
