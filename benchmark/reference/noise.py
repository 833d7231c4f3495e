"""Frozen copy of the program's position-indexed noise rule.

A value depends only on (seed, stream, position, channel): positions are
cut into chunks of 256, and each chunk is ``torch.randn(256, channels)``
from a CPU ``torch.Generator`` seeded by splitmix64 over (seed, stream,
chunk).  Stream 1 is the prior's noise over frames, stream 2 the
duration predictor's over phonemes.
"""

from __future__ import annotations

import torch

CHUNK = 256
PRIOR_STREAM = 1
DURATION_STREAM = 2
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix(*values: int) -> int:
    """Integers hashed into one 63-bit generator seed."""
    h = 0
    for v in values:
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h >> 1


def positions(seed: int, stream: int, count: int,
              channels: int) -> torch.Tensor:
    """Standard normal noise ``[count, channels]`` for positions
    ``0 .. count - 1``."""
    gen = torch.Generator()
    chunks = []
    for chunk in range(max(1, -(-count // CHUNK))):
        gen.manual_seed(mix(seed, stream, chunk))
        chunks.append(torch.randn(CHUNK, channels, generator=gen))
    return torch.cat(chunks)[:count]
