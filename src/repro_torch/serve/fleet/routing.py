"""Deterministic stream->shard routing via rendezvous (HRW) hashing.

A copy of the reference's ``repro.serve.fleet.routing``: routes must be
identical in both packages (``tests/test_torch_fleet.py``).

The fleet needs a routing function that (a) is deterministic across
processes and restarts — the same stream id must land on the same shard no
matter which frontend computes the route, so ``hash()`` (randomized per
process by PYTHONHASHSEED) is out; and (b) is *stable under shard-count
change*: draining shard k must remap only shard k's streams, not reshuffle
the whole fleet the way ``crc32(sid) % n`` does.

Highest-random-weight (rendezvous) hashing gives both: every (stream,
shard) pair gets a 64-bit weight from a keyed blake2b digest and the
stream lives on the highest-weight *eligible* shard.  Removing a shard
from the eligible set promotes each of its streams to their next-best
shard and touches nothing else — the property the drain/decommission path
and its tests rely on.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Sequence


def hrw_weight(stream_id: str, shard_key: str) -> int:
    """64-bit rendezvous weight of a (stream, shard) pair — a keyed
    blake2b digest, deterministic across processes and platforms."""
    h = hashlib.blake2b(digest_size=8)
    h.update(stream_id.encode("utf-8"))
    h.update(b"\x00")
    h.update(shard_key.encode("utf-8"))
    return struct.unpack("<Q", h.digest())[0]


def rank_shards(stream_id: str, shard_keys: Sequence[str]) -> list[int]:
    """All shard indices ranked best-first by rendezvous weight.
    Index 0 is the stream's home shard; the rest is its failover order
    (ties broken by shard index, which blake2b makes vanishingly rare)."""
    return sorted(range(len(shard_keys)),
                  key=lambda i: (-hrw_weight(stream_id, shard_keys[i]), i))


def route(stream_id: str, shard_keys: Sequence[str],
          eligible: Sequence[bool] | None = None) -> int:
    """The stream's home shard: highest rendezvous weight among eligible
    shards.  ``eligible`` masks out drained/decommissioned shards; routing
    for every other stream is unchanged (the HRW stability property)."""
    best, best_w = -1, -1
    for i, key in enumerate(shard_keys):
        if eligible is not None and not eligible[i]:
            continue
        w = hrw_weight(stream_id, key)
        if w > best_w:
            best, best_w = i, w
    if best < 0:
        raise ValueError("no eligible shard to route to")
    return best
