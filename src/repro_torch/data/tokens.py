"""Deterministic synthetic LM token pipeline (a copy of the reference
``repro.data.tokens``, numpy only).

Production shape: a stateless, seekable token source — batch ``i`` is a pure
function of (seed, step, shard) so that (a) restarts resume exactly
(fault tolerance: no data replay / loss), (b) each data-parallel shard
draws disjoint streams without coordination, (c) stragglers can be
re-assigned shards deterministically.

The stream is a mixture of Zipfian unigrams and short repeated motifs so
that a language model has actual structure to learn in the examples.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.3


def _rng_for(cfg: TokenStreamConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xA11CE])
    )


def batch_at(cfg: TokenStreamConfig, step: int, shard: int = 0, num_shards: int = 1):
    """Tokens for one step/shard: (local_batch, seq_len+1) int32.

    Returns inputs/targets packed together; callers slice [:, :-1]/[:, 1:].
    """
    local = cfg.global_batch // num_shards
    rng = _rng_for(cfg, step, shard)
    v = cfg.vocab_size
    # Zipf over a shuffled alphabet (stable shuffle from the seed only)
    base = rng.zipf(cfg.zipf_a, size=(local, cfg.seq_len + 1)).astype(np.int64)
    toks = (base - 1) % v
    # overlay repeated motifs (structure for the model to learn)
    n_motifs = max(1, int(cfg.motif_prob * cfg.seq_len / cfg.motif_len))
    for b in range(local):
        motif = rng.integers(0, v, size=cfg.motif_len)
        for _ in range(n_motifs):
            p = int(rng.integers(0, cfg.seq_len - cfg.motif_len))
            toks[b, p:p + cfg.motif_len] = motif
    return toks.astype(np.int32)


def lm_batch(cfg: TokenStreamConfig, step: int, shard: int = 0, num_shards: int = 1):
    toks = batch_at(cfg, step, shard, num_shards)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
