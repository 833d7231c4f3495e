"""Seeded inputs from a traffic file's parameters.

Every seed gets the same sizes: a pool of lengths at fixed quantiles of
the mix's distribution, which each client (or the call loop) takes in an
order of its own drawn from the seed; only the order and the content
change with the seed.
"""

from __future__ import annotations

import math
import statistics
import typing

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def length_pool(spec: typing.Mapping[str, typing.Any]) -> typing.List[int]:
    """``pool`` lengths at the quantiles ``(i + 0.5) / pool`` of a
    log-normal of median ``median`` and shape ``sigma``, clipped to
    ``[min, max]``."""
    dist = statistics.NormalDist(math.log(spec["median"]), spec["sigma"])
    n = spec["pool"]
    return [int(min(spec["max"], max(spec["min"], round(math.exp(
        dist.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def sentence(r: np.random.Generator, chars: int,
             spec: typing.Mapping[str, typing.Any]) -> str:
    """``chars`` characters of words over ``alphabet``, one space between
    words, of ``word_min`` to ``word_max`` letters."""
    alphabet = spec["alphabet"]
    words: typing.List[str] = []
    size = -1
    while size < chars:
        n = int(r.integers(spec["word_min"], spec["word_max"] + 1))
        words.append("".join(alphabet[i] for i in r.integers(
            0, len(alphabet), n)))
        size += n + 1
    text = " ".join(words)[:chars]
    return text.rstrip() + alphabet[0] * (chars - len(text.rstrip()))


class Cycle:
    """A client's endless sequence of texts: the pool in its own order,
    reshuffled at each pass."""

    def __init__(self, seed: int, client: int,
                 spec: typing.Mapping[str, typing.Any]):
        self.r = rng(seed, 7, client)
        self.spec = spec
        self.pool = length_pool(spec)
        self.order: typing.List[int] = []

    def next(self) -> str:
        if not self.order:
            self.order = list(self.r.permutation(self.pool))
        return sentence(self.r, int(self.order.pop()), self.spec)
