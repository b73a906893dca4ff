"""Perplexity: teacher-forced NLL over a token stream (port of
llama_gguf_tpu/engine/perplexity.py).

Chunked like llama.cpp's perplexity tool: non-overlapping windows, each one
batched prefill (``runner.step``) on a one-row cache of its own
(``init_kv(1, owner=PPL_OWNER)``), so it never zeroes a request's cache. A
window is padded to its prefill bucket (padding carries position max_seq
and is dropped), so a short trailing window replays the graph of its bucket
instead of capturing one for its exact length. The log-softmax and the
target gather run on the device in f32; one scalar per chunk crosses to the
host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .runner import bucket_len, read_bucket

PPL_OWNER = "perplexity"


@dataclass
class PerplexityResult:
    nll_sum: float = 0.0
    count: int = 0
    per_chunk_ppl: list = field(default_factory=list)

    @property
    def nll(self) -> float:
        return self.nll_sum / self.count if self.count else 0.0

    @property
    def ppl(self) -> float:
        return float(np.exp(self.nll))


@torch.no_grad()
def _chunk_nll(runner, ids: list[int]) -> tuple[float, int]:
    """Sum NLL of ids[1:] under teacher forcing; returns (nll_sum, n)."""
    t = len(ids)
    bt = bucket_len(t)
    kv = runner.init_kv(1, owner=PPL_OWNER)
    toks = np.zeros((1, bt), np.int32)
    toks[0, :t] = ids
    pos = np.full((1, bt), runner.max_seq, np.int32)  # padding: dropped
    pos[0, :t] = np.arange(t)
    logits, _ = runner.step(toks, pos, np.array([t], np.int32), kv,
                            read_bound=read_bucket(t, runner.max_seq))
    logp = torch.log_softmax(logits[0, : t - 1].float(), dim=-1)
    targets = torch.as_tensor(ids[1:], dtype=torch.long,
                              device=logp.device)
    nll = -logp.gather(-1, targets[:, None]).sum()
    return float(nll), t - 1


def perplexity(runner, token_ids: list[int], chunk: int = 512,
               progress=None) -> PerplexityResult:
    """Chunked perplexity over a token stream (non-overlapping windows,
    llama.cpp-style)."""
    if len(token_ids) < 2:
        raise ValueError("perplexity needs at least 2 tokens")
    chunk = min(chunk, runner.max_seq)
    result = PerplexityResult()
    # full chunks plus the trailing partial window (>= 2 tokens)
    windows = [token_ids[i: i + chunk]
               for i in range(0, len(token_ids), chunk)]
    if len(windows[-1]) < 2:
        windows.pop()
    for c, ids in enumerate(windows):
        nll, n = _chunk_nll(runner, ids)
        result.nll_sum += nll
        result.count += n
        result.per_chunk_ppl.append(float(np.exp(nll / max(n, 1))))
        if progress:
            progress(c + 1, len(windows), result.ppl)
    return result
