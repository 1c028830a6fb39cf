"""The one traffic generator: requests drawn from a mix's parameters.

A mix gives its prompt and output lengths as distributions
(``{"dist": "log_uniform" | "uniform", "min", "max"}``) and a ``block``
size.  The stream is cut into blocks; every block holds the same
``block`` lengths of each kind, at the midpoints of ``block`` equal
strata of the distribution, paired and ordered by permutations drawn
from the seed.  So every seed offers the same set of sizes in another
order, and any run of whole blocks has the same mix.  Token ids are
uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def strata(dist: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the midpoints of ``n`` equal-probability
    strata of ``dist``."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "log_uniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    if dist["dist"] == "uniform":
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


@dataclasses.dataclass
class Request:
    index: int
    tokens: np.ndarray          # (s,) int32 prompt
    max_new: int


class RequestStream:
    """Requests in order, block by block, from ``seed``."""

    def __init__(self, mix: dict, seed: int, vocab: int, key: int = 0):
        self.mix, self.seed, self.vocab, self.key = mix, int(seed), vocab, key
        self.block = mix["block"]
        self.prompts = strata(mix["prompt"], self.block)
        self.outputs = strata(mix["output"], self.block)
        self._n = 0

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, self.key, *key]))

    def next(self) -> Request:
        """The next request."""
        k, j = divmod(self._n, self.block)
        rng = self._rng(k, 0)
        pp, po = (rng.permutation(self.block) for _ in range(2))
        s, new = int(self.prompts[pp[j]]), int(self.outputs[po[j]])
        toks = self._rng(k, 1, j).integers(0, self.vocab, s, dtype=np.int64)
        r = Request(self._n, toks.astype(np.int32), new)
        self._n += 1
        return r

    def sample(self, key: int, population: list, n: int) -> list:
        """``n`` of ``population`` drawn from the seed (all if fewer)."""
        rng = self._rng(key, 2)
        idx = rng.permutation(len(population))[:n]
        return [population[i] for i in sorted(idx)]
