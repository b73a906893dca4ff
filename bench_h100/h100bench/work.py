"""The roofline reckoning: what a step's inputs need, whatever implements it.

Operations are 2·rows·K·N a product (and attention's per (query, key)
pair, from the family's ``attention_work``), counted once against the
published dense bf16 peak; bytes are each weight's GGUF block bytes (Q4_K
144 B and Q6_K 210 B per 256 weights, Q5_1 24 B per 32), the activations
read once and the outputs written once in bf16 (the logits in f32), and the
cache each row's context needs. Rows are the step's real tokens, not its
padding. The port's own layout (its scale panels, its padded grid) counts
for nothing. The bound of a piece of work is the larger of its operations
over the peak and its bytes over the bandwidth.

Peaks of one NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import ggml

PEAK_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3
ACT = 2  # bytes of an activation (bf16)


@dataclass
class Work:
    flops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.flops + o.flops, self.nbytes + o.nbytes)

    @property
    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.nbytes / PEAK_BYTES)

    @property
    def binds(self) -> str:
        return ("operations" if self.flops / PEAK_FLOPS
                >= self.nbytes / PEAK_BYTES else "bytes")


class ModelWork:
    """Per-step work of one configuration, from its GGUF tensors."""

    def __init__(self, cfg: dict, family):
        self.cfg, self.family = cfg, family
        self.dense: list[tuple[int, int, int]] = []  # (K, N, bytes)
        self.attn_dense: list[tuple[int, int, int]] = []  # MLA's W_kv_b
        self.experts: list[tuple[int, int, int, int]] = []  # (E, K, N, B/e)
        self.topk = int(cfg.get("num_experts_per_tok", 0))
        for name, shape, fmt, init in family.layout(cfg)[1]:
            if init != "quant":  # norms, routers, biases: glue
                continue
            nb = ggml.block_bytes(ggml.pick_format(fmt, shape[-1]),
                                  math.prod(shape))
            if name == "token_embd.weight":
                self.embed_row = nb // shape[0]
            elif name == "output.weight":
                self.head = (shape[1], shape[0], nb)
            elif len(shape) == 3:
                self.experts.append((shape[0], shape[2], shape[1],
                                     nb // shape[0]))
            elif name.endswith("attn_kv_b.weight"):
                self.attn_dense.append((shape[1], shape[0], nb))
            else:
                self.dense.append((shape[1], shape[0], nb))

    @staticmethod
    def _products(mats, rows: int) -> Work:
        w = Work()
        for k, n, nb in mats if rows else ():
            w += Work(2.0 * rows * k * n, nb + rows * (k + n) * ACT)
        return w

    def step(self, rows, head_rows: int) -> dict[str, Work]:
        """Work by part of one step. ``rows``: (new tokens, first position)
        of each live row; ``head_rows``: rows whose logits are read. Every
        expert's bytes count: the metrics read steps whose slots leave an
        expert idle with negligible chance."""
        tokens = sum(n for n, _ in rows)
        pairs = sum(n * s + n * (n + 1) // 2 for n, s in rows)
        ctx = sum(s for n, s in rows)
        out = {"dense": self._products(self.dense, tokens)}
        k, v, nb = self.head
        out["head"] = Work(2.0 * head_rows * k * v,
                           nb + head_rows * (k * ACT + v * 4)) \
            if head_rows else Work()
        slots = tokens * self.topk
        moe = Work()
        for e, k, n, per in self.experts:
            moe += Work(2.0 * slots * k * n, e * per + slots * (k + n) * ACT)
        out["experts"] = moe if tokens else Work()
        af, ab = self.family.attention_work(self.cfg, pairs, tokens, ctx)
        out["attention"] = Work(af, ab) + self._products(self.attn_dense,
                                                         tokens)
        out["embed"] = Work(0.0, tokens * (self.embed_row + self.head[0] * ACT))
        return out


def total(parts: dict[str, Work], keys=None) -> Work:
    w = Work()
    for key, part in parts.items():
        if keys is None or key in keys:
            w += part
    return w
