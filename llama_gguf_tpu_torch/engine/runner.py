"""ModelRunner: prefill and decode steps over the functional model (port of
llama_gguf_tpu/engine/runner.py).

    step(tokens[B,T], positions[B,T], lengths[B], kv) -> (logits, kv)

PyTorch runs eagerly, so a step is one call of models/transformer.forward;
the KV cache is updated in place. Prefill pads the prompt to a bucket length
(padding tokens carry position max_seq and are dropped by the cache write),
and attention reads the KV cache up to a power-of-two read bucket. Decode is
one forward per token; greedy_decode keeps the argmax on the device and
fetches the tokens once per call. CUDA graphs are ROADMAP queue 1.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models import kv as KV
from ..models.config import ModelConfig
from ..models.loader import resolve_device
from ..models.transformer import forward

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_len(t: int) -> int:
    for b in PREFILL_BUCKETS:
        if t <= b:
            return b
    return int(2 ** math.ceil(math.log2(t)))


READ_BOUND_MIN = 256


def read_bucket(n: int, max_seq: int) -> int:
    """KV read bound covering ``n`` live positions: the smallest power of two
    >= n (floor 256, cap max_seq)."""
    if n >= max_seq:
        return max_seq
    b = READ_BOUND_MIN
    while b < n:
        b *= 2
    return min(b, max_seq)


class ModelRunner:
    def __init__(self, params: dict, cfg: ModelConfig, max_batch: int = 1,
                 max_seq: int | None = None,
                 matmul_precision: str = "highest",
                 kv_format: str | None = None, device="cuda"):
        """``matmul_precision``: "highest" (f32 throughout, no TF32) or
        "default", in which the quantized kernels emit bf16 outputs, rounded
        once from their f32 sums (the JAX package's _out_dtype). The port's
        own torch matmuls (attention, router, dense weights) stay f32 in
        "default", where the JAX package on a TPU takes one bf16 pass.
        ``kv_format``: f32 | bf16 KV-cache storage."""
        if matmul_precision not in ("highest", "default"):
            raise ValueError(f"unknown matmul_precision {matmul_precision!r}: "
                             "'highest' or 'default'")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 parity: no TF32 in cuBLAS matmuls (dense and attention)
            torch.backends.cuda.matmul.allow_tf32 = False
        kv_format = kv_format or "f32"
        self.params = params
        self.cfg = dataclasses.replace(cfg, kv_format=kv_format)
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq_len
        self.kv_format = kv_format
        self.matmul_precision = matmul_precision

    # -- state ---------------------------------------------------------------

    def init_kv(self, batch: int | None = None) -> dict:
        return KV.init_cache(
            self.cfg.num_layers, batch or self.max_batch, self.max_seq,
            self.cfg.cache_kv_heads, self.cfg.cache_k_dim,
            v_head_dim=self.cfg.cache_v_dim, fmt=self.kv_format,
            device=self.device)

    # -- steps ---------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int32).to(self.device)

    @torch.no_grad()
    def step(self, tokens, positions, lengths, kv: dict,
             read_bound: int | None = None, logit_positions=None
             ) -> tuple[torch.Tensor, dict]:
        """Run one step. tokens/positions [B, T], lengths [B] (int arrays or
        tensors). ``read_bound``: cap on KV positions attention reads (all
        valid positions must be < read_bound); use read_bucket() to pick.
        ``logit_positions``: optional [B] per-row T-index — the LM head runs
        on that single position per row and logits come back [B, 1, V]."""
        tokens = self._tensor(tokens)
        t = tokens.shape[1]
        if read_bound is not None:
            read_bound = min(read_bound, self.max_seq)
        lp = (self._tensor(logit_positions)
              if logit_positions is not None and t > 1 else None)
        return forward(self.params, self.cfg, tokens,
                       self._tensor(positions), kv, self._tensor(lengths),
                       read_bound=read_bound, logit_positions=lp,
                       precision=self.matmul_precision)

    @staticmethod
    def plan_segments(start: int, steps: int,
                      max_seq: int) -> list[tuple[int, int]]:
        """Chunk a ``steps``-token decode starting after position ``start``
        into (chunk_len, read_bound) segments that never cross a read-bucket
        boundary, so each runs with the smallest bound covering its
        positions. Chunk lengths are powers of two."""
        plan: list[tuple[int, int]] = []
        done = 0
        while done < steps:
            bound = read_bucket(start + done + 1, max_seq)
            cap = bound - (start + done)
            if cap <= 0:
                # past the cache end: positions >= max_seq are dropped
                cap = steps - done
            room = min(cap, steps - done)
            chunk = 1 << (room.bit_length() - 1)  # largest pow2 <= room
            plan.append((chunk, bound))
            done += chunk
        return plan

    @torch.no_grad()
    def greedy_decode(self, tokens0, pos0, kv, steps: int):
        """Run ``steps`` greedy decode steps. tokens0/pos0: [B] (the last
        sampled token and its position per sequence). Returns (generated
        [B, steps] int32 tensor on the device, kv). The argmax stays on the
        device; the caller fetches the tokens once."""
        toks = self._tensor(tokens0)
        pos = self._tensor(pos0)
        start = int(pos.max().item())
        outs = []
        done = 0
        for chunk, bound in self.plan_segments(start, steps, self.max_seq):
            for _ in range(chunk):
                p = pos + done
                logits, kv = forward(self.params, self.cfg, toks[:, None],
                                     p[:, None], kv, p + 1, read_bound=bound,
                                     precision=self.matmul_precision)
                toks = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
                outs.append(toks)
                done += 1
        return torch.stack(outs, dim=1), kv

    # -- single-sequence prefill + decode ------------------------------------

    def prefill(self, token_ids: list[int], kv: dict, batch_idx: int = 0,
                start_pos: int = 0) -> tuple[torch.Tensor, dict, int]:
        """Prefill one sequence (padded to a bucket). Returns (last-token
        logits [V], kv, seq_len). ``start_pos`` > 0 continues from an
        existing KV prefix."""
        t = len(token_ids)
        bt = bucket_len(t)
        b = KV.cache_shape(kv)[1]
        toks = torch.zeros((b, bt), dtype=torch.int32)
        toks[batch_idx, :t] = torch.as_tensor(token_ids, dtype=torch.int32)
        pos = torch.full((b, bt), self.max_seq, dtype=torch.int32)  # dropped
        pos[batch_idx, :t] = start_pos + torch.arange(t, dtype=torch.int32)
        lengths = torch.zeros((b,), dtype=torch.int32)
        lengths[batch_idx] = start_pos + t
        logits, kv = self.step(
            toks, pos, lengths, kv,
            read_bound=read_bucket(start_pos + t, self.max_seq),
            logit_positions=torch.full((b,), t - 1, dtype=torch.int32))
        return logits[batch_idx, logits.shape[1] - 1], kv, start_pos + t

    def decode_one(self, token_id: int, pos: int, kv: dict,
                   batch_idx: int = 0) -> tuple[torch.Tensor, dict]:
        """Single-token decode for one sequence. Returns (logits [V], kv)."""
        b = KV.cache_shape(kv)[1]
        toks = torch.zeros((b, 1), dtype=torch.int32)
        toks[batch_idx, 0] = token_id
        posa = torch.full((b, 1), self.max_seq, dtype=torch.int32)
        posa[batch_idx, 0] = pos
        lengths = torch.zeros((b,), dtype=torch.int32)
        lengths[batch_idx] = pos + 1
        logits, kv = self.step(toks, posa, lengths, kv,
                               read_bound=read_bucket(pos + 1, self.max_seq))
        return logits[batch_idx, 0], kv
