"""Consistent-hash model ownership, plainly, from docs/design/sharding.md.

A model is hashed by its ``model_id`` onto a ring that holds 64 points
("vnodes") for each live shard; the shard whose point comes next
clockwise after the model's hash owns the model, and the ring wraps
around past its last point. A shard's points are the hashes of
``shard-<id>-vnode-<v>``; points with equal hashes are ordered by shard
id. The hash is the CRC-32 of the UTF-8 bytes (the reflected polynomial
0xEDB88320, initial value and final XOR 0xFFFFFFFF), finalized with
murmur3's fmix32: ``h ^= h >> 16; h *= 0x85EBCA6B; h ^= h >> 13;
h *= 0xC2B2AE35; h ^= h >> 16``, all modulo 2**32.

The CRC is written here bit by bit, with no table and no library hash.
"""

from __future__ import annotations

VNODES = 64
MASK = 0xFFFFFFFF


def crc32(data: bytes) -> int:
    crc = MASK
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0xEDB88320 if crc & 1 else crc >> 1
    return crc ^ MASK


def fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK
    h ^= h >> 16
    return h


def key_hash(text: str) -> int:
    return fmix32(crc32(text.encode("utf-8")))


def points(shards) -> list[tuple[int, int]]:
    """The ring: (hash, shard) for every vnode of every live shard, in
    clockwise order."""
    return sorted((key_hash(f"shard-{s}-vnode-{v}"), s)
                  for s in set(shards) for v in range(VNODES))


def assign(model_ids, shards) -> dict[str, int]:
    """Each model's owner among the live ``shards`` (none if there is no
    live shard)."""
    ring = points(shards)
    if not ring:
        return {}
    out = {}
    for model in model_ids:
        h = key_hash(model)
        # The first point above h, by halving [lo, hi).
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] > h:
                hi = mid
            else:
                lo = mid + 1
        out[model] = ring[lo % len(ring)][1]
    return out
