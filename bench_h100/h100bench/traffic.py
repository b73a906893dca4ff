"""The one traffic generator: requests from a mix's parameters
(bench_h100/traffic/<mix>.json) and ``--seed``.

Every seed gets the same sizes: prompt and output lengths are the
quantiles (i + 0.5) / n of their clipped lognormals, in an order the seed
draws (``order: "seed"``) or one order drawn once from a constant seed
(``order: "fixed"``, for mixes whose metrics followed the order: B's
output rate differed by 17% between seeds and by under 4% between runs of
one seed). Prompt ids are drawn from the seed over the vocabulary minus
the ids the run bans.

The loop is closed (``loop: "closed"``): ``clients`` streams, each
finished request submitting the next one, in blocks of ``grid`` requests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

ORDER_SEED = 20240118  # the order of a mix's sizes where it is "fixed"
FIRST_ID = 3  # ids 0-2 are <unk>, <s>, </s>


@dataclass
class Request:
    index: int  # order in the stream
    ids: list[int]
    max_tokens: int


def size_grid(spec: dict, n: int) -> np.ndarray:
    """n lengths: the quantiles (i + 0.5) / n of a lognormal with the
    spec's median and sigma, clipped to [min, max] and rounded."""
    nd = NormalDist()
    q = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.exp(math.log(spec["median"]) + spec["sigma"] * q)
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


class Traffic:
    """Requests of one run. ``seed`` may be any integer."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        s = int(seed) % (1 << 63)
        self._order = np.random.default_rng(
            [s if spec["order"] == "seed" else ORDER_SEED, 1])
        self._ids = np.random.default_rng([s, 2])
        self.check_rng = np.random.default_rng([s, 3])
        self._block: list[tuple[int, int]] = []
        self.made = 0

    def _make(self, index: int, prompt: int, out: int) -> Request:
        ids = self._ids.integers(FIRST_ID, self.vocab, size=prompt)
        return Request(index, ids.tolist(), int(out))

    def _sizes(self, n: int) -> list[tuple[int, int]]:
        p = self._order.permutation(size_grid(self.spec["prompt"], n))
        o = self._order.permutation(size_grid(self.spec["output"], n))
        return list(zip(p.tolist(), o.tolist()))

    def next_size(self) -> tuple[int, int]:
        """The next (prompt, output) lengths."""
        if not self._block:
            self._block = self._sizes(self.spec["grid"])
        return self._block.pop(0)

    def next(self) -> Request:
        """The next request."""
        p, o = self.next_size()
        self.made += 1
        return self._make(self.made - 1, p, o)
