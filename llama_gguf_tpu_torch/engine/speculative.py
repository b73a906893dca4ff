"""Speculative decoding: a draft model, an early-exit self-draft, or prompt
lookup, verified by the target in one step (port of
llama_gguf_tpu/engine/speculative.py).

The verification is ONE runner step over the window of unconsumed tokens
and the drafts ([1, T] tokens at their positions, padded to the 8-row
bucket), so on the card it replays the runner's (batch, 8, read bound)
graph. The argmax runs on the device and only k ints come back. A rejection
rolls the caches back by length alone: the rejected positions lie past the
sequence's length, masked until they are overwritten, so no K/V moves.

That rollback is exact only for a cache that holds positions. A recurrent
layer's state (DeltaNet, the Mamba family, Falcon-H1's parallel hybrid) has
already consumed the rejected drafts, and nothing rolls it back: the JAX
package's self-draft on a hybrid model parts from plain greedy decoding. So
both decoders refuse a target or draft with such layers, and an encoder-only
or T5 model, which has no decoder runner (ROADMAP queue 3).

The self-draft is a second ModelRunner over the target's own tensors (its
first N layers; nothing is copied), with its own caches and graphs. Where
the draft is the target itself, its cache is a second one of the runner's,
owned by "draft", so the two never share positions.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..models import kv as KV
from ..models.mamba import KINDS as MAMBA_KINDS
from .runner import ModelRunner, bucket_len, read_bucket

log = logging.getLogger(__name__)

# layer kinds whose state the runner keeps in the cache: rejected drafts
# advance it, and a rollback by length cannot undo that
RECURRENT_KINDS = frozenset(("deltanet", *MAMBA_KINDS))
DRAFT_OWNER = "draft"  # the draft's cache when the draft is the target


@dataclass
class SpeculativeStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    bonus: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_round(self) -> float:
        total = self.accepted + self.bonus
        return total / self.rounds if self.rounds else 0.0


def refuse_unrollable(runner: ModelRunner | None, role: str) -> None:
    """Raise NotImplementedError for a runner whose cache cannot roll back
    by length: no decoder runner (an encoder-only or T5 model), or layers
    with recurrent state."""
    if runner is None:
        raise NotImplementedError(
            f"speculative decoding needs a decoder model: the {role} is an "
            "encoder-only or encoder-decoder (T5) model, which has no "
            "decoder runner")
    if getattr(runner, "mesh", None) is not None:
        raise NotImplementedError(
            f"speculative decoding over a mesh is not supported (the {role} "
            "runs on a mesh): the draft's runner would make device calls "
            "the mesh's other ranks do not make (ROADMAP queue 3)")
    kinds = sorted(set(runner.cfg.layer_kinds or ()) & RECURRENT_KINDS)
    if kinds:
        raise NotImplementedError(
            f"speculative decoding of models with {'/'.join(kinds)} layers "
            f"is not supported (the {role}): rejected drafts advance the "
            "recurrent state, and there is no rollback for it, so the "
            "output would part from plain greedy decoding (ROADMAP queue 3)")


def make_self_draft(runner: ModelRunner, exit_layer: int) -> ModelRunner:
    """Early-exit draft: the same weights, the first ``exit_layer`` layers
    only. Tensors are aliased (no copy); the draft runner has its own
    caches and graphs, which the target's reset_graphs drops too."""
    params = dict(runner.params)
    params["layers"] = runner.params["layers"][:exit_layer]
    cfg = dataclasses.replace(
        runner.cfg, num_layers=exit_layer,
        layer_kinds=tuple(runner.cfg.layer_kinds[:exit_layer])
        if runner.cfg.layer_kinds else ())
    draft = ModelRunner(params, cfg, max_batch=runner.max_batch,
                        max_seq=runner.max_seq,
                        matmul_precision=runner.matmul_precision,
                        kv_format=runner.kv_format, device=runner.device,
                        swa_ring=runner.swa_ring,
                        swa_ring_extra=runner.swa_ring_extra)
    runner.share_params(draft)  # a params rewrite resets both's graphs
    return draft


def _window_dev(runner: ModelRunner, tokens: list[int], start_pos: int,
                kv: dict) -> tuple[torch.Tensor, dict]:
    """One step consuming ``tokens`` at positions start_pos...; returns
    (the logits [len(tokens), V] on the device, kv). Callers that need only
    token ids take the argmax on the device and fetch k ints."""
    t = len(tokens)
    b = KV.cache_shape(kv)[1]
    bt = bucket_len(t)
    toks = np.zeros((b, bt), np.int32)
    toks[0, :t] = tokens
    pos = np.full((b, bt), runner.max_seq, np.int32)
    pos[0, :t] = start_pos + np.arange(t)
    lengths = np.zeros((b,), np.int32)
    lengths[0] = start_pos + t
    logits, kv = runner.step(toks, pos, lengths, kv,
                             read_bound=read_bucket(start_pos + t,
                                                    runner.max_seq))
    return logits[0, :t], kv


def _window(runner: ModelRunner, tokens: list[int], start_pos: int,
            kv: dict) -> tuple[np.ndarray, dict]:
    """_window_dev with a host copy (the sampled path needs whole rows)."""
    logits, kv = _window_dev(runner, tokens, start_pos, kv)
    return logits.float().cpu().numpy(), kv


def _draft_greedy_on_device(draft: ModelRunner, tail: list[int], nd: int,
                            dkv: dict, k: int) -> tuple[list[int], dict]:
    """Draft k greedy tokens with one window step, one greedy_decode of
    k - 1 steps (graph replays chained on the device) and one fetch of k
    ints."""
    dlog, dkv = _window_dev(draft, tail, nd, dkv)
    nd_new = nd + len(tail)
    b = KV.cache_shape(dkv)[1]
    t0 = torch.zeros((b,), dtype=torch.int32, device=dlog.device)
    t0[0] = torch.argmax(dlog[-1])
    if k > 1:
        rest, dkv = draft.greedy_decode(t0, np.full((b,), nd_new, np.int64),
                                        dkv, steps=k - 1)
        drafts_dev = torch.cat([t0[:1], rest[0]])
    else:
        drafts_dev = t0[:1]
    return drafts_dev.cpu().tolist(), dkv


def _argmax_ints(logits: torch.Tensor) -> list[int]:
    """The argmax of each row, on the device; k ints fetched."""
    return torch.argmax(logits, dim=-1).cpu().tolist()


class SpeculativeDecoder:
    """K-token draft + single-pass target verification.

    Invariant: ``hist`` is the accepted token stream (prompt + generated);
    nt/nd count how many of hist the target/draft models have consumed into
    their caches. hist[nt:] is exactly the unconsumed tail (never empty
    after the prefill: the latest accepted token).
    """

    def __init__(self, target: ModelRunner, draft: ModelRunner,
                 num_draft: int = 4):
        refuse_unrollable(target, "target")
        refuse_unrollable(draft, "draft")
        self.target = target
        self.draft = draft
        self.k = num_draft
        self.stats = SpeculativeStats()

    @classmethod
    def self_speculative(cls, target: ModelRunner,
                         exit_layer: int | None = None,
                         num_draft: int = 4) -> "SpeculativeDecoder":
        refuse_unrollable(target, "target")
        n = exit_layer or max(1, target.cfg.num_layers // 4)
        return cls(target, make_self_draft(target, n), num_draft=num_draft)

    def _caches(self) -> tuple[dict, dict]:
        """The target's and the draft's caches, zeroed (the draft's a
        second one, owned by DRAFT_OWNER, where it is the target)."""
        tkv = self.target.init_kv()
        owner = DRAFT_OWNER if self.draft is self.target else None
        return tkv, self.draft.init_kv(owner=owner)

    def generate_greedy(self, prompt_ids: list[int], max_tokens: int,
                        is_eog=None) -> list[int]:
        """Greedy speculative decode; the output equals plain greedy
        decoding of the target (verification guarantees it)."""
        tkv, dkv = self._caches()

        hist = list(prompt_ids)
        tlogits, tkv, _ = self.target.prefill(prompt_ids, tkv)
        nt = len(prompt_ids)
        _, dkv, _ = self.draft.prefill(prompt_ids, dkv)
        nd = len(prompt_ids)

        first = int(torch.argmax(tlogits))
        hist.append(first)
        out = [first]
        if is_eog and is_eog(first):
            return out

        max_seq = self.target.max_seq
        while len(out) < max_tokens and len(hist) + self.k + 1 < max_seq:
            k = min(self.k, max_tokens - len(out))

            # draft: consume the unconsumed tail, then draft k tokens (the
            # draft cache consumes drafts[:k-1] at positions nd..nd+k-2;
            # those entries stay valid exactly for the accepted prefix)
            drafts, dkv = _draft_greedy_on_device(
                self.draft, hist[nd:], nd, dkv, k)
            nd = len(hist)
            nd_base = nd
            nd = nd + k - 1
            self.stats.drafted += k

            # verify: one target step over [tail..., drafts[:-1]]
            window = hist[nt:] + drafts[:-1]
            start = nt
            vlogits, tkv = _window_dev(self.target, window, start, tkv)
            nt = start + len(window)
            # the last k window rows verify drafts[0..k-1]
            greedy = _argmax_ints(vlogits[-k:])

            accepted = 0
            for i in range(k):
                if drafts[i] == greedy[i]:
                    accepted += 1
                else:
                    break
            self.stats.accepted += accepted
            self.stats.rounds += 1

            new_tokens = drafts[:accepted]
            if accepted < k:
                new_tokens = new_tokens + [greedy[accepted]]
                self.stats.bonus += 1
                # roll both caches back to the accepted prefix
                nt = len(hist) + accepted
                nd = min(nd, nd_base + accepted)
            # accepted == k: everything consumed is valid; drafts[k-1]
            # becomes the unconsumed tail

            stop = False
            for tok in new_tokens:
                hist.append(tok)
                out.append(tok)
                if (is_eog and is_eog(tok)) or len(out) >= max_tokens:
                    stop = True
                    break
            if stop:
                break
        return out

    def generate_sampled(self, prompt_ids: list[int], max_tokens: int,
                         sampler_config, seed: int | None = None,
                         is_eog=None) -> list[int]:
        """Stochastic speculative sampling: draft token x is accepted with
        probability min(1, p_target(x) / p_draft(x)); on a rejection the
        token is drawn from norm(max(0, p_target - p_draft)). The output
        distribution equals sampling the target directly. The draws come
        from ``numpy.random.default_rng(seed)`` in the JAX package's order,
        so the same seed gives the same tokens."""
        from ..sampling.sampler import Sampler

        if getattr(sampler_config, "mirostat", 0):
            raise ValueError(
                "speculative sampling is incompatible with Mirostat (its "
                "state adapts per observed token); use plain decoding")
        tgt_sampler = Sampler(sampler_config)
        dft_sampler = Sampler(sampler_config)
        rng = np.random.default_rng(seed)

        tkv, dkv = self._caches()
        hist = list(prompt_ids)
        tlogits, tkv, _ = self.target.prefill(prompt_ids, tkv, host=True)
        nt = len(prompt_ids)
        _, dkv, _ = self.draft.prefill(prompt_ids, dkv)
        nd = len(prompt_ids)

        p0 = tgt_sampler.probs(tlogits, hist)
        first = int(rng.choice(p0.shape[0], p=p0))
        hist.append(first)
        out = [first]
        if is_eog and is_eog(first):
            return out

        max_seq = self.target.max_seq
        while len(out) < max_tokens and len(hist) + self.k + 1 < max_seq:
            k = min(self.k, max_tokens - len(out))

            dlog, dkv = _window(self.draft, hist[nd:], nd, dkv)
            nd = len(hist)
            drafts: list[int] = []
            draft_probs: list[np.ndarray] = []
            cur_logits = dlog[-1]
            for i in range(k):
                p = dft_sampler.probs(cur_logits, hist + drafts)
                tok = int(rng.choice(p.shape[0], p=p))
                drafts.append(tok)
                draft_probs.append(p)
                if i < k - 1:
                    cur_logits, dkv = self.draft.decode_one(tok, nd + i, dkv,
                                                            host=True)
            nd_base = nd
            nd = nd + k - 1
            self.stats.drafted += k

            # one target step over [tail..., drafts] -> k + 1 rows: row i
            # gives p_target at drafts[i]'s position, the last row the
            # distribution after all k drafts
            window = hist[nt:] + drafts
            start = nt
            vlogits, tkv = _window(self.target, window, start, tkv)
            nt = start + len(window)
            trows = vlogits[-(k + 1):]

            accepted = 0
            resampled: int | None = None
            for i in range(k):
                pt = tgt_sampler.probs(trows[i], hist + drafts[:i])
                pd = draft_probs[i]
                x = drafts[i]
                ratio = pt[x] / pd[x] if pd[x] > 0 else 0.0
                if rng.random() < min(1.0, ratio):
                    accepted += 1
                    continue
                residual = np.maximum(pt - pd, 0.0)
                tot = residual.sum()
                if tot <= 0:
                    residual, tot = pt, pt.sum()
                resampled = int(rng.choice(residual.shape[0],
                                           p=residual / tot))
                break
            self.stats.accepted += accepted
            self.stats.rounds += 1

            new_tokens = drafts[:accepted]
            if resampled is not None:
                new_tokens = new_tokens + [resampled]
                self.stats.bonus += 1
                nt = len(hist) + accepted
                nd = min(nd, nd_base + accepted)
            else:
                # all accepted: the bonus token from the last target row
                pt = tgt_sampler.probs(trows[k], hist + drafts)
                new_tokens = new_tokens + [int(rng.choice(pt.shape[0],
                                                          p=pt))]
                self.stats.bonus += 1

            stop = False
            for tok in new_tokens:
                hist.append(tok)
                out.append(tok)
                if (is_eog and is_eog(tok)) or len(out) >= max_tokens:
                    stop = True
                    break
            if stop:
                break
        return out

    def generate_plain_greedy(self, prompt_ids: list[int],
                              max_tokens: int) -> list[int]:
        """Non-speculative greedy decoding of the target (the reference the
        speculative output is held to)."""
        kv = self.target.init_kv()
        logits, kv, pos = self.target.prefill(prompt_ids, kv)
        out = []
        for _ in range(max_tokens):
            tok = int(torch.argmax(logits))
            out.append(tok)
            if pos >= self.target.max_seq - 1 or len(out) >= max_tokens:
                break
            logits, kv = self.target.decode_one(tok, pos, kv)
            pos += 1
        return out


class PromptLookupDecoder:
    """Draft-model-free speculation: the proposals are copied from the
    latest earlier occurrence of the current suffix n-gram in the context
    (prompt lookup, n-gram speculation), then verified by the same one-step
    window as SpeculativeDecoder's. Its output equals plain greedy decoding
    of the target whatever the proposals are."""

    def __init__(self, target: ModelRunner, num_draft: int = 8,
                 max_ngram: int = 3):
        refuse_unrollable(target, "target")
        self.target = target
        self.k = num_draft
        self.max_ngram = max_ngram
        self.stats = SpeculativeStats()

    def _propose(self, hist: list[int], k: int) -> list[int]:
        """Longest-suffix n-gram match: for n = max_ngram..1, find the most
        recent earlier occurrence of hist[-n:]; propose up to k tokens that
        followed it."""
        length = len(hist)
        if length < 2 or k <= 0:
            return []
        h = np.asarray(hist, np.int64)
        for n in range(min(self.max_ngram, length - 1), 0, -1):
            pat = h[length - n:]
            body = h[: length - 1]  # windows strictly before the suffix
            if body.shape[0] < n:
                continue
            win = np.lib.stride_tricks.sliding_window_view(body, n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if hits.size == 0:
                continue
            i = int(hits[-1])  # the most recent occurrence
            cont = hist[i + n: i + n + k]
            if cont:
                return cont
        return []

    def generate_greedy(self, prompt_ids: list[int], max_tokens: int,
                        is_eog=None) -> list[int]:
        """Greedy prompt-lookup decode (SpeculativeDecoder.generate_greedy's
        invariants, with no draft cache)."""
        tkv = self.target.init_kv()
        hist = list(prompt_ids)
        tlogits, tkv, _ = self.target.prefill(prompt_ids, tkv)
        nt = len(prompt_ids)

        first = int(torch.argmax(tlogits))
        hist.append(first)
        out = [first]
        if is_eog and is_eog(first):
            return out

        max_seq = self.target.max_seq
        while len(out) < max_tokens and len(hist) + self.k + 1 < max_seq:
            drafts = self._propose(hist, min(self.k, max_tokens - len(out)))
            k = len(drafts)
            window = hist[nt:] + (drafts[:-1] if k else [])
            vlogits, tkv = _window_dev(self.target, window, nt, tkv)
            nt += len(window)
            self.stats.rounds += 1
            self.stats.drafted += k

            if k == 0:  # no n-gram match: a plain one-token step
                new_tokens = _argmax_ints(vlogits[-1:])
                self.stats.bonus += 1
            else:
                greedy = _argmax_ints(vlogits[-k:])
                accepted = 0
                for i in range(k):
                    if drafts[i] == greedy[i]:
                        accepted += 1
                    else:
                        break
                self.stats.accepted += accepted
                new_tokens = drafts[:accepted]
                if accepted < k:
                    new_tokens = new_tokens + [greedy[accepted]]
                    self.stats.bonus += 1
                    nt = len(hist) + accepted  # back to the accepted prefix
                # accepted == k: drafts[k-1] stays the unconsumed tail

            stop = False
            for tok in new_tokens:
                hist.append(tok)
                out.append(tok)
                if (is_eog and is_eog(tok)) or len(out) >= max_tokens:
                    stop = True
                    break
            if stop:
                break
        return out
