"""Deterministic synthetic token pipeline — stateless, resumable, elastic.

The port's own copy of ``repro.data.pipeline``, which is numpy only: the
same code gives the same batches, bit for bit, in both packages.

Batch content is a pure function of (seed, step, global position), so:
  * restart at step N reproduces exactly the batches a crashed run saw,
  * re-sharding to a different host/device count changes nothing (each host
    materializes only its slice of the same global batch),
  * no filesystem or service dependency in CI.

The token stream is a mixture of Zipf-ish unigram draws and a repeated-
n-gram process, which gives language-like compressible structure (loss
actually decreases during the example trainings rather than sitting at
log V).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "global_batch", "host_shard", "batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 8


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD15EA5E]))


def global_batch(cfg: DataConfig, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) for one global step, shape (B, S) int32."""
    rng = _rng(cfg, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    # zipf-ish unigrams
    ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
    toks = (ranks - 1) % v
    # overlay repeated n-grams for learnable structure
    n_rep = max(1, s // (4 * cfg.ngram))
    motif = rng.integers(0, v, size=(b, cfg.ngram))
    for i in range(n_rep):
        pos = rng.integers(0, s + 1 - cfg.ngram, size=b)
        for row in range(b):
            toks[row, pos[row]:pos[row] + cfg.ngram] = motif[row]
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def host_shard(arr: np.ndarray, host_id: int, n_hosts: int) -> np.ndarray:
    """The slice of the global batch this host feeds to its local devices."""
    b = arr.shape[0]
    if b % n_hosts:
        raise ValueError(f"global batch {b} does not split over {n_hosts} "
                         f"hosts")
    per = b // n_hosts
    return arr[host_id * per:(host_id + 1) * per]


def batches(cfg: DataConfig, start_step: int = 0,
            host_id: int = 0, n_hosts: int = 1) -> Iterator:
    step = start_step
    while True:
        toks, labels = global_batch(cfg, step)
        yield (host_shard(toks, host_id, n_hosts),
               host_shard(labels, host_id, n_hosts), step)
        step += 1
