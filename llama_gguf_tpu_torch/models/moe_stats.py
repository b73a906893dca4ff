"""MoE routing statistics: the expert-selection histogram and the
load-balance factor (port of llama_gguf_tpu/models/moe_stats.py).

``MoeStats.record`` takes the routing's expert ids (``models/transformer.
route``'s ``topi``, on any device, or a numpy array); the load-balance
factor is max load / mean load, 1.0 when every expert is picked equally
often.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MoeStats:
    num_experts: int
    counts: np.ndarray = field(default=None)
    tokens_routed: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.num_experts, np.int64)

    def record(self, top_experts) -> None:
        """top_experts: int ids [..., k] of the selected experts, a numpy
        array or a tensor (copied to the host)."""
        if hasattr(top_experts, "detach"):
            top_experts = top_experts.detach().cpu().numpy()
        flat = np.asarray(top_experts).reshape(-1)
        np.add.at(self.counts, flat, 1)
        self.tokens_routed += flat.size

    @property
    def load_balance_factor(self) -> float:
        """max / mean selection count; 1.0 is perfectly balanced."""
        if self.tokens_routed == 0:
            return 1.0
        mean = self.counts.mean()
        return float(self.counts.max() / mean) if mean > 0 else 1.0

    @property
    def histogram(self) -> dict[int, int]:
        return {i: int(c) for i, c in enumerate(self.counts)}

    def reset(self) -> None:
        self.counts[:] = 0
        self.tokens_routed = 0


def route_and_record(router_logits: np.ndarray, k: int,
                     stats: MoeStats | None = None) -> np.ndarray:
    """Host-side helper: the top-k expert ids of logits [..., E], recorded
    in ``stats`` when given."""
    top = np.argsort(-np.asarray(router_logits), axis=-1)[..., :k]
    if stats is not None:
        stats.record(top)
    return top
