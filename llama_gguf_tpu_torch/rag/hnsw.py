"""Pure-numpy HNSW approximate nearest-neighbor index (port of
llama_gguf_tpu/rag/hnsw.py, the same code).

Standard HNSW (Malkov & Yashunin): a multi-level skip-list graph, greedy
descent on the upper levels, ef-bounded best-first search on level 0.
Cosine (default) and dot distances, serialization, and brute force for
tiny collections. The level draws come from ``random.Random(seed)`` and the
arithmetic is the JAX package's numpy, so ``to_bytes`` gives its bytes on
the same inputs and each package's ``from_bytes`` reads the other's. The
graph keeps insertion order, which the bytes depend on. The walk stays on
the host: a few dozen dot products a hop.
"""

from __future__ import annotations

import heapq
import json
import math
import random
from typing import Any

import numpy as np


class HNSWIndex:
    def __init__(self, dim: int, m: int = 16, ef_construction: int = 100,
                 metric: str = "cosine", seed: int = 0):
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.metric = metric
        self._rng = random.Random(seed)
        self._ml = 1.0 / math.log(m)
        self.vectors = np.zeros((0, dim), np.float32)
        self.ids: list[Any] = []
        self.levels: list[int] = []
        # neighbors[level][node] -> list[int]
        self.graph: list[dict[int, list[int]]] = []
        self.entry: int = -1

    # -- distance ----------------------------------------------------------------

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32).reshape(-1)
        if self.metric == "cosine":
            n = np.linalg.norm(v)
            if n > 0:
                v = v / n
        return v

    def _dist(self, v: np.ndarray, idx) -> np.ndarray:
        # stored vectors are pre-normalized for cosine -> dist = 1 - dot
        return 1.0 - self.vectors[idx] @ v

    # -- insert ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.ids)

    def add(self, external_id: Any, vector: np.ndarray) -> None:
        v = self._prep(vector)
        node = len(self.ids)
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self.vectors = np.vstack([self.vectors, v[None]])
        self.ids.append(external_id)
        self.levels.append(level)
        while len(self.graph) <= level:
            self.graph.append({})
        for lv in range(level + 1):
            self.graph[lv][node] = []

        if self.entry < 0:
            self.entry = node
            return

        ep = self.entry
        top = self.levels[self.entry]
        # greedy descent above the node's level
        for lv in range(top, level, -1):
            ep = self._greedy(v, ep, lv)
        # insert with ef search at each level
        for lv in range(min(level, top), -1, -1):
            cands = self._search_level(v, [ep], lv, self.ef_construction)
            mmax = self.m0 if lv == 0 else self.m
            selected = self._select(cands, mmax)
            self.graph[lv][node] = [c for _, c in selected]
            for _, c in selected:
                nbrs = self.graph[lv][c]
                nbrs.append(node)
                if len(nbrs) > mmax:
                    dists = self._dist(self.vectors[c], nbrs)
                    order = np.argsort(dists)[:mmax]
                    self.graph[lv][c] = [nbrs[i] for i in order]
            ep = cands[0][1]
        if level > top:
            self.entry = node

    def _greedy(self, v: np.ndarray, ep: int, level: int) -> int:
        cur = ep
        cur_d = float(self._dist(v, [cur])[0])
        improved = True
        while improved:
            improved = False
            nbrs = self.graph[level].get(cur, [])
            if nbrs:
                d = self._dist(v, nbrs)
                i = int(np.argmin(d))
                if d[i] < cur_d:
                    cur, cur_d = nbrs[i], float(d[i])
                    improved = True
        return cur

    def _search_level(self, v: np.ndarray, eps: list[int], level: int,
                      ef: int) -> list[tuple[float, int]]:
        visited = set(eps)
        cand: list[tuple[float, int]] = []
        best: list[tuple[float, int]] = []
        for e in eps:
            d = float(self._dist(v, [e])[0])
            heapq.heappush(cand, (d, e))
            heapq.heappush(best, (-d, e))
        while cand:
            d, c = heapq.heappop(cand)
            if best and d > -best[0][0]:
                break
            for nb in self.graph[level].get(c, []):
                if nb in visited:
                    continue
                visited.add(nb)
                dn = float(self._dist(v, [nb])[0])
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cand, (dn, nb))
                    heapq.heappush(best, (-dn, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted([(-nd, n) for nd, n in best])

    @staticmethod
    def _select(cands: list[tuple[float, int]], m: int) -> list[tuple[float, int]]:
        return cands[:m]

    # -- query --------------------------------------------------------------------

    def search(self, vector: np.ndarray, k: int = 5,
               ef: int | None = None) -> list[tuple[Any, float]]:
        """Returns [(external_id, similarity)] best-first."""
        if not self.ids:
            return []
        v = self._prep(vector)
        if len(self.ids) <= 64:  # brute force beats graph walk when tiny
            sims = self.vectors @ v
            order = np.argsort(-sims)[:k]
            return [(self.ids[i], float(sims[i])) for i in order]
        ef = max(ef or 50, k)
        ep = self.entry
        for lv in range(self.levels[self.entry], 0, -1):
            ep = self._greedy(v, ep, lv)
        found = self._search_level(v, [ep], 0, ef)[:k]
        return [(self.ids[n], 1.0 - d) for d, n in found]

    # -- persistence ----------------------------------------------------------------

    def to_bytes(self) -> bytes:
        meta = {
            "dim": self.dim, "m": self.m, "ef_construction": self.ef_construction,
            "metric": self.metric, "ids": self.ids, "levels": self.levels,
            "entry": self.entry,
            "graph": [{str(k): v for k, v in g.items()} for g in self.graph],
        }
        mb = json.dumps(meta).encode()
        return (len(mb).to_bytes(8, "little") + mb
                + self.vectors.astype(np.float32).tobytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> "HNSWIndex":
        n = int.from_bytes(data[:8], "little")
        meta = json.loads(data[8: 8 + n])
        idx = cls(meta["dim"], meta["m"], meta["ef_construction"],
                  meta["metric"])
        idx.ids = meta["ids"]
        idx.levels = meta["levels"]
        idx.entry = meta["entry"]
        idx.graph = [{int(k): v for k, v in g.items()} for g in meta["graph"]]
        vecs = np.frombuffer(data[8 + n:], np.float32)
        idx.vectors = vecs.reshape(-1, meta["dim"]).copy()
        return idx
