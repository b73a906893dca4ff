"""Token sampling pipeline.

A copy of llama_gguf_tpu/sampling/sampler.py (the port never imports the JAX
package). Pipeline order: repetition penalty ->
frequency/presence penalties -> Mirostat-v2 (optional) -> temperature ->
softmax -> greedy if T==0 -> min-p -> top-k -> top-p -> renormalize ->
multinomial draw. Host-side numpy on the logits vector; the engine keeps a
device-side greedy path to avoid the D2H logits copy when no penalties or
stochastic sampling are configured.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class SamplerConfig:
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0
    repetition_penalty: float = 1.1
    repetition_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0  # 0 off, 2 = mirostat-v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: int | None = None
    # OpenAI logit_bias: token id -> additive bias on the raw logits
    # (applied before penalties/temperature; -100/+100 ~ ban/force)
    logit_bias: dict | None = None

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def needs_history(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
        )


@dataclass
class Sampler:
    config: SamplerConfig = field(default_factory=SamplerConfig)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.config.seed)
        self._mu = 2.0 * self.config.mirostat_tau

    def reset(self):
        self._mu = 2.0 * self.config.mirostat_tau
        self.rng = np.random.default_rng(self.config.seed)

    def sample(self, logits: np.ndarray, history: Sequence[int] = (),
               mask: np.ndarray | None = None) -> int:
        cfg = self.config
        logits = self._apply_penalties(logits, history, mask)
        if cfg.is_greedy:
            return int(np.argmax(logits))
        if cfg.mirostat == 2:
            return self._sample_mirostat_v2(logits)
        probs = self._pipeline_probs(logits)
        if probs is None:
            return int(np.argmax(logits))
        return int(self.rng.choice(probs.shape[0], p=probs))

    def probs(self, logits: np.ndarray, history: Sequence[int] = (),
              mask: np.ndarray | None = None) -> np.ndarray:
        """Full post-pipeline probability distribution (for speculative
        acceptance sampling). Greedy config -> one-hot."""
        cfg = self.config
        logits = self._apply_penalties(logits, history, mask)
        if cfg.is_greedy:
            p = np.zeros(logits.shape[0], np.float32)
            p[int(np.argmax(logits))] = 1.0
            return p
        p = self._pipeline_probs(logits)
        if p is None:
            p = np.zeros(logits.shape[0], np.float32)
            p[int(np.argmax(logits))] = 1.0
        return p

    def _apply_penalties(self, logits, history, mask) -> np.ndarray:
        cfg = self.config
        logits = np.asarray(logits, np.float32).copy()
        if cfg.logit_bias:
            for tid, bias in cfg.logit_bias.items():
                tid = int(tid)
                if 0 <= tid < logits.shape[0]:
                    logits[tid] += float(bias)
        if mask is not None:  # grammar constraint: True = allowed
            logits[~mask] = -np.inf
        if cfg.repetition_penalty != 1.0 and history:
            recent = np.unique(np.asarray(history[-cfg.repetition_last_n:], np.int64))
            recent = recent[(recent >= 0) & (recent < logits.shape[0])]
            vals = logits[recent]
            logits[recent] = np.where(
                vals > 0, vals / cfg.repetition_penalty, vals * cfg.repetition_penalty
            )
        if (cfg.frequency_penalty != 0.0 or cfg.presence_penalty != 0.0) and history:
            hist = np.asarray(history, np.int64)
            hist = hist[(hist >= 0) & (hist < logits.shape[0])]
            ids, counts = np.unique(hist, return_counts=True)
            logits[ids] -= cfg.frequency_penalty * counts
            logits[ids] -= cfg.presence_penalty
        return logits

    def _pipeline_probs(self, logits: np.ndarray) -> np.ndarray | None:
        """temperature -> softmax -> min-p -> top-k -> top-p -> renorm.
        None when everything got filtered out."""
        cfg = self.config
        logits = logits / max(cfg.temperature, 1e-6)
        probs = _softmax(logits)

        if cfg.min_p > 0.0:
            pmax = probs.max()
            probs = np.where(probs >= cfg.min_p * pmax, probs, 0.0)

        if cfg.top_k > 0 and cfg.top_k < probs.shape[0]:
            kth = np.partition(probs, -cfg.top_k)[-cfg.top_k]
            probs = np.where(probs >= kth, probs, 0.0)

        if 0.0 < cfg.top_p < 1.0:
            order = np.argsort(probs)[::-1]
            sorted_p = probs[order]
            csum = np.cumsum(sorted_p)
            cutoff_idx = int(np.searchsorted(csum, cfg.top_p) + 1)
            keep = order[:cutoff_idx]
            newp = np.zeros_like(probs)
            newp[keep] = probs[keep]
            probs = newp

        total = probs.sum()
        if total <= 0:
            return None
        return probs / total

    def _sample_mirostat_v2(self, logits: np.ndarray) -> int:
        cfg = self.config
        logits = logits / max(cfg.temperature, 1e-6)
        probs = _softmax(logits)
        surprises = -np.log2(np.maximum(probs, 1e-30))
        allowed = surprises <= self._mu
        if not allowed.any():
            allowed[np.argmax(probs)] = True
        p = np.where(allowed, probs, 0.0)
        p = p / p.sum()
        tok = int(self.rng.choice(p.shape[0], p=p))
        observed = float(surprises[tok])
        self._mu -= cfg.mirostat_eta * (observed - cfg.mirostat_tau)
        return tok


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - np.max(x)
    e = np.exp(x)
    return e / e.sum()
