"""Deterministic, seekable data pipeline (port of
``repro/data/pipeline.py``).

``batch_at(step)`` is a pure function of (seed, step): after a failure the
promoted replica or the restarted job regenerates exactly the batches it
needs, so replay is recomputation and no bytes are logged.

The token ids are the reference's, bit for bit. It draws
``uniform(fold_in(key(seed), step), (B, S + 1))`` with JAX's threefry-2x32
under ``jax_threefry_partitionable=True`` and shapes the draw into
Zipf-ish tokens as ``(u ** 4 * (V - 1)).astype(int32)``. This module
reproduces each step in numpy:

  * ``key(seed)`` is the pair (0, the seed's 32 bits);
  * ``fold_in(key, d)`` hashes the counter pair (0, d) under the key;
  * the partitionable ``random_bits`` hashes the counters (0, i) for the
    flat index i of every element and XORs the two output words;
  * ``uniform`` ORs the top 23 bits into the bits of 1.0 and subtracts 1;
  * ``u ** 4`` is JAX's ``integer_pow``: ``(u * u) * (u * u)`` in f32.

Batches are host numpy arrays; the train workload moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key`` = (k0, k1); uint32 arrays of one shape in and out."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def seed_key(seed: int):
    """``jax.random.key(seed)``'s key data with 64-bit types off (JAX's
    default): the seed as a 32-bit integer, so the high word is 0 and the
    low word its bits."""
    return _U32(0), _U32(int(seed) & 0xFFFFFFFF)


def fold_in(key, data: int):
    """``jax.random.fold_in``: the hash of (0, data) under ``key``."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return a[0], b[0]


def random_bits32(key, shape) -> np.ndarray:
    """Partitionable ``random_bits(key, 32, shape)``: counters (hi, lo) of
    the flat element index, the two hashed words XORed."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1)."""
    bits = random_bits32(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    return ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)


class TokenSource:
    """Counter-based: batch i never depends on batches < i."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        key = fold_in(seed_key(cfg.seed), step)
        u = uniform(key, (cfg.global_batch, cfg.seq_len + 1))
        u2 = u * u
        tok = (u2 * u2 * np.float32(cfg.vocab_size - 1)).astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    host_batch_at = batch_at


class ShardedSource:
    """Per-worker view: worker w of W reads rows [w::W] of the global
    batch, so sample order does not depend on the worker count."""

    def __init__(self, src: TokenSource, worker: int, n_workers: int):
        assert src.cfg.global_batch % n_workers == 0
        self.src = src
        self.worker = worker
        self.n = n_workers

    def batch_at(self, step: int) -> dict:
        g = self.src.host_batch_at(step)
        return {k: v[self.worker::self.n] for k, v in g.items()}
