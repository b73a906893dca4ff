"""T5 encoder-decoder (and t5encoder encoder-only) models; port of
llama_gguf_tpu/models/t5.py.

llama.cpp's tensor naming (enc.blk.N.* / dec.blk.N.*), the relative-position
bias table on layer 0 shared by the stack, unscaled attention scores,
RMSNorm pre-norm blocks, a ReLU or gated-GELU FFN by tensor presence, and a
tied head scaled by d_model ** -0.5 when output.weight is absent.

The encoder is one batched bidirectional forward; the decoder is an
incremental step over a self-attention cache (one drop slot at index
``max_seq`` takes out-of-range writes, as models/kv.py's buffers do) with the
cross-attention K/V projected once from the encoder output. Where the JAX
package runs separate products, the self-attention q|k|v are one fused
product and the gated FFN's gate|up one GLU product (kernel 3 with
act="gelu" on quantized weights).

``T5Runner`` keeps one decoder cache of its own (batch 1): the self cache,
cross K/V buffers sized for the longest encoder input so far (``enc_capacity``
rows, a multiple of 16) and the encoder mask as a device tensor. Each request
encodes its prompt eagerly, copies its cross K/V into those buffers in place
(rows past its length zeroed and masked), and on CUDA every decoder step
replays one CUDA graph captured on them after one eager warm-up, as the
decoder runner's steps do (engine/runner.py). A step on a cache made
elsewhere (``make_cache``) runs eagerly and counts in ``eager_steps``.
"""

from __future__ import annotations

import functools
import threading
from typing import Any

import numpy as np
import torch

from ..engine.runner import ModelRunner, _device_lock
from ..ops import linear as L
from ..ops.linear import QuantLinear
from ..ops.norms import rms_norm
from ..ops.qmatmul import glu_combine, qmatmul_glu

NEG_INF = -1e30
ENC_PAD = 16  # encoder inputs are padded to a multiple of this


# -- relative position buckets (HF T5Attention._relative_position_bucket) ----

@functools.lru_cache(maxsize=None)
def _log_f32(x: float) -> float:
    """log of x rounded to float32, in float32 (as the JAX package takes the
    log of a Python scalar), on the host: no device copy inside a graph."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def _rel_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                max_distance: int) -> torch.Tensor:
    """rel = key_pos - query_pos -> bucket index [same shape]. The
    log-spaced bucket in float32, in the JAX package's order of operations,
    truncated toward zero."""
    nb = num_buckets
    ret = torch.zeros_like(rel)
    if bidirectional:
        nb = nb // 2
        ret = ret + (rel > 0).to(rel.dtype) * nb
        n = torch.abs(rel)
    else:
        n = -torch.clamp(rel, max=0)
    max_exact = nb // 2
    is_small = n < max_exact
    # log-spaced buckets for distances in [max_exact, max_distance)
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    large = max_exact + (
        torch.log(nf / max_exact) / _log_f32(max_distance / max_exact)
        * (nb - max_exact)
    ).to(rel.dtype)
    large = torch.clamp(large, max=nb - 1)
    return ret + torch.where(is_small, n, large)


def _rel_bias(table: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              bidirectional: bool, num_buckets: int,
              max_distance: int) -> torch.Tensor:
    """table [buckets, heads]; q_pos [B, T]; k_pos [S] -> [B, heads, T, S]."""
    rel = k_pos[None, None, :] - q_pos[:, :, None]  # [B, T, S]
    bucket = _rel_bucket(rel, bidirectional, num_buckets, max_distance)
    return table.float()[bucket.long()].permute(0, 3, 1, 2)


def _attend(q, k, v, bias, mask):
    """q [B,T,nh,hd]; k/v [B,S,nh,hd]; bias [B,nh,T,S] or None;
    mask [B,T,S] bool. T5 scores are UNSCALED (no 1/sqrt(d)); the
    probabilities of a fully masked row are 0."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        scores = scores + bias
    off = ~mask[:, None]
    probs = torch.softmax(scores.masked_fill(off, NEG_INF), dim=-1)
    probs = probs.masked_fill(off, 0.0)
    return torch.einsum("bhts,bshd->bthd", probs, v.float())


def _ffn(layer: dict, cfg, x: torch.Tensor,
         precision: str | None = None) -> torch.Tensor:
    h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
    ffn = layer["ffn"]
    act = None
    if "gate_up" in ffn:  # t5 v1.1 / flan: gated GELU, one fused product
        lin = ffn["gate_up"]
        if isinstance(lin, QuantLinear):
            act = qmatmul_glu(h.reshape(-1, h.shape[-1]).float(), lin,
                              "gelu", precision)
            if act is not None:
                act = act.reshape(*h.shape[:-1], -1)
        if act is None:
            gu = L.apply(lin, h, precision).float()
            f = lin.splits[0]
            act = glu_combine(gu[..., :f], gu[..., f:], "gelu")
    elif "gate" in ffn:
        g = L.apply(ffn["gate"], h, precision).float()
        u = L.apply(ffn["up"], h, precision).float()
        act = glu_combine(g, u, "gelu")
    else:  # original t5: ReLU
        act = torch.relu(L.apply(ffn["up"], h, precision).float())
    return x + L.apply(ffn["down"], act.to(x.dtype), precision)


def t5_encode(params: dict, cfg, tokens: torch.Tensor, mask: torch.Tensor,
              precision: str | None = None) -> torch.Tensor:
    """Bidirectional encoder: tokens/mask [B, T] -> hidden [B, T, H]."""
    enc = params["enc"]
    nh, hd = cfg.num_heads, cfg.head_dim
    b, t = tokens.shape
    x = params["embed"][tokens.long()]
    ar = torch.arange(t, dtype=torch.int32, device=tokens.device)
    bias = _rel_bias(enc["rel_b"], ar[None].expand(b, t), ar, True,
                     cfg.rel_buckets, cfg.rel_max_distance)
    amask = mask[:, None, :] & mask[:, :, None]  # [B, T, S]
    for layer in enc["layers"]:
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        a = layer["attn"]
        q, k, v = (y.reshape(b, t, nh, hd)
                   for y in L.apply_qkv(a, h, precision))
        ctx = _attend(q, k, v, bias, amask)
        x = x + L.apply(a["wo"], ctx.reshape(b, t, nh * hd).to(x.dtype),
                        precision)
        x = _ffn(layer, cfg, x, precision)
    return rms_norm(x, enc["output_norm"], cfg.norm_eps)


def t5_cross_kv(params: dict, cfg, enc_out: torch.Tensor,
                precision: str | None = None
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Each decoder layer's cross K and V [B, S_enc, nh, hd] f32, projected
    once from the encoder output."""
    nh, hd = cfg.num_heads, cfg.head_dim
    b, s_enc = enc_out.shape[:2]
    ks, vs = [], []
    for layer in params["dec"]["layers"]:
        c = layer["cross"]
        ks.append(L.apply(c["wk"], enc_out, precision)
                  .reshape(b, s_enc, nh, hd).float())
        vs.append(L.apply(c["wv"], enc_out, precision)
                  .reshape(b, s_enc, nh, hd).float())
    return ks, vs


def t5_init_cache(params: dict, cfg, batch: int, max_seq: int,
                  enc_out: torch.Tensor,
                  precision: str | None = None) -> dict:
    """Decoder state: per-layer self-attention K/V [batch, max_seq + 1, nh,
    hd] (the last slot drops out-of-range writes) and the cross K/V
    projected once from the encoder output."""
    nh, hd = cfg.num_heads, cfg.head_dim
    n = len(params["dec"]["layers"])

    def zeros():
        return torch.zeros((batch, max_seq + 1, nh, hd), dtype=torch.float32,
                           device=enc_out.device)

    ck, cv = t5_cross_kv(params, cfg, enc_out, precision)
    return {"k": [zeros() for _ in range(n)], "v": [zeros() for _ in range(n)],
            "ck": ck, "cv": cv}


def t5_decode_step(params: dict, cfg, tokens: torch.Tensor,
                   positions: torch.Tensor, lengths: torch.Tensor,
                   cache: dict, enc_mask: torch.Tensor,
                   precision: str | None = None
                   ) -> tuple[torch.Tensor, dict]:
    """Incremental decoder step, the self cache updated in place.

    tokens/positions [B, T]; lengths [B] = valid self-KV length after this
    step; enc_mask [B, S_enc] (S_enc = the cross cache's rows). Returns
    (logits [B, T, V] f32, cache). The self cache's mask reads all max_seq
    slots (k_pos < lengths), as in the JAX package."""
    dec = params["dec"]
    nh, hd = cfg.num_heads, cfg.head_dim
    b, t = tokens.shape
    s = cache["k"][0].shape[1] - 1  # max_seq; index s is the drop slot
    dev = tokens.device
    positions = positions.to(torch.int32)
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    k_pos = torch.arange(s, dtype=torch.int32, device=dev)
    bias = _rel_bias(dec["rel_b"], positions, k_pos, False,
                     cfg.rel_buckets, cfg.rel_max_distance)
    causal = (k_pos[None, None, :] <= positions[:, :, None]) & \
             (k_pos[None, None, :] < lengths[:, None, None])
    cross_mask = enc_mask[:, None, :].expand(b, t, enc_mask.shape[1])
    slot = torch.where(positions < s, positions,
                       torch.full_like(positions, s)).long()
    b_idx = torch.arange(b, device=dev)[:, None]
    for i, layer in enumerate(dec["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        a = layer["attn"]
        q, k, v = L.apply_qkv(a, h, precision)
        q = q.reshape(b, t, nh, hd)
        cache["k"][i][b_idx, slot] = k.reshape(b, t, nh, hd).float()
        cache["v"][i][b_idx, slot] = v.reshape(b, t, nh, hd).float()
        ctx = _attend(q, cache["k"][i][:, :s], cache["v"][i][:, :s], bias,
                      causal)
        x = x + L.apply(a["wo"], ctx.reshape(b, t, nh * hd).to(x.dtype),
                        precision)

        h2 = rms_norm(x, layer["cross_norm"], cfg.norm_eps)
        c = layer["cross"]
        qc = L.apply(c["wq"], h2, precision).reshape(b, t, nh, hd)
        ctx2 = _attend(qc, cache["ck"][i], cache["cv"][i], None, cross_mask)
        x = x + L.apply(c["wo"], ctx2.reshape(b, t, nh * hd).to(x.dtype),
                        precision)
        x = _ffn(layer, cfg, x, precision)
    x = rms_norm(x, dec["output_norm"], cfg.norm_eps)
    if params.get("output") is not None:
        logits = L.apply(params["output"], x, precision)
    else:  # tied: HF scales by d_model**-0.5 before the shared projection
        xs = x * (cfg.hidden_size ** -0.5)
        logits = xs.float() @ params["embed"].float().T
    return logits.float(), cache


# -- loading -----------------------------------------------------------------

def _load_stack(loader, prefix: str, n: int, cross: bool) -> dict:
    def linear_any(*names):
        for name in names[:-1]:
            got = loader.linear(name, required=False)
            if got is not None:
                return got
        return loader.linear(names[-1])

    def vec(name):
        return loader._put(loader.dense(name))

    layers = []
    for i in range(n):
        p = f"{prefix}.blk.{i}"
        attn: dict[str, Any] = {
            "wq": loader.linear(f"{p}.attn_q"),
            "wk": loader.linear(f"{p}.attn_k"),
            "wv": loader.linear(f"{p}.attn_v"),
            "wo": linear_any(f"{p}.attn_o", f"{p}.attn_output")}
        loader._fuse_attn(attn)
        ffn: dict[str, Any] = {}
        if loader.has(f"{p}.ffn_gate.weight"):
            ffn["gate"] = loader.linear(f"{p}.ffn_gate")
        ffn["up"] = loader.linear(f"{p}.ffn_up")
        ffn["down"] = loader.linear(f"{p}.ffn_down")
        loader._fuse_ffn(ffn)
        layer: dict[str, Any] = {
            "attn_norm": vec(f"{p}.attn_norm.weight"),
            "attn": attn,
            "ffn_norm": vec(f"{p}.ffn_norm.weight"),
            "ffn": ffn,
        }
        if cross:
            layer["cross_norm"] = vec(f"{p}.cross_attn_norm.weight")
            layer["cross"] = {
                "wq": loader.linear(f"{p}.cross_attn_q"),
                "wk": loader.linear(f"{p}.cross_attn_k"),
                "wv": loader.linear(f"{p}.cross_attn_v"),
                "wo": linear_any(f"{p}.cross_attn_o",
                                 f"{p}.cross_attn_output"),
            }
        layers.append(layer)
    return {
        "layers": layers,
        # the bucket table [buckets, heads], on layer 0 only, shared by the
        # stack
        "rel_b": vec(f"{prefix}.blk.0.attn_rel_b.weight"),
        "output_norm": vec(f"{prefix}.output_norm.weight"),
    }


def load_t5(loader, cfg) -> dict:
    """T5 params from a llama.cpp-convention GGUF (enc./dec. prefixes); for
    arch 't5encoder' only the encoder stack exists. Stack depths are
    counted by tensor presence (the decoder's may differ from the metadata
    block count). The embedding table stays dense, as in the JAX package."""

    def depth(prefix: str) -> int:
        n = 0
        while loader.has(f"{prefix}.blk.{n}.attn_q.weight"):
            n += 1
        return n

    params: dict[str, Any] = {
        "embed": loader._put(loader.dense("token_embd.weight")),
        "enc": _load_stack(loader, "enc", depth("enc"), cross=False),
    }
    if loader.has("dec.blk.0.attn_q.weight"):
        params["dec"] = _load_stack(loader, "dec", depth("dec"), cross=True)
    if loader.has("output.weight"):
        params["output"] = loader.linear("output")
    return params


# -- runner ------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-max(n, 1) // m) * m


class T5Runner:
    """Encoder-decoder runner for the Engine (the JAX T5Runner, graphed).

    Encoder inputs are padded to a multiple of 16 and encoded eagerly; the
    decoder runs one token per step over a ``max_seq``-slot self cache. On
    CUDA each step on the runner's own cache replays one CUDA graph (key
    ("t5", enc_capacity)); the ``_lock`` of the device serializes every
    CUDA call with the other runners' on it, and ``stream`` (a lock) keeps
    one request at a time on the own cache. Counters as ModelRunner's:
    ``replays``, ``captures``, ``capture_seconds`` (their total),
    ``pool_bytes``, ``eager_steps``."""

    def __init__(self, params: dict, cfg, max_seq: int = 0, device="cuda",
                 matmul_precision: str = "highest"):
        from .loader import resolve_device

        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq or min(cfg.max_seq_len, 1024)
        self.device = resolve_device(device)
        self.matmul_precision = matmul_precision
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity
        # the cross buffers' rows: the model's context, grown by a longer
        # input
        self.enc_capacity = _round_up(cfg.max_seq_len, ENC_PAD)
        self._lock = _device_lock(self.device)
        self.stream = threading.Lock()  # one request on the own cache
        self._own: dict | None = None  # cache, mask, io buffers
        self._graphs: dict[tuple, Any] = {}
        self._pool = None
        self.eager_steps = 0
        self.replays: dict[tuple, int] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    # the decoder runner's capture and replay (warm-up on a side stream,
    # "thread_local" capture into the runner's pool, launches credited per
    # replay)
    _capture = ModelRunner._capture
    _replay = ModelRunner._replay

    # -- encoder -----------------------------------------------------------

    def _encode(self, ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        t = _round_up(len(ids), ENC_PAD)
        tok = np.zeros((1, t), np.int32)
        tok[0, :len(ids)] = ids
        mask = np.zeros((1, t), bool)
        mask[0, :len(ids)] = True
        tok_t = torch.from_numpy(tok).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        return t5_encode(self.params, self.cfg, tok_t, mask_t,
                         self.matmul_precision), mask_t

    @torch.no_grad()
    def encode_ids(self, ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """(enc_out [1, T16, H], mask [1, T16]) on the device."""
        with self._lock:
            return self._encode(ids)

    @torch.no_grad()
    def encode_host(self, ids: list[int]) -> np.ndarray:
        """The encoder's hidden states of ``ids`` [len(ids), H] on the host,
        copied under the device lock."""
        with self._lock:
            enc_out, _ = self._encode(ids)
            return enc_out[0, :len(ids)].float().cpu().numpy()

    @torch.no_grad()
    def make_cache(self, enc_out: torch.Tensor) -> dict:
        """A new decoder cache for ``enc_out`` (its steps run eagerly)."""
        with self._lock:
            return t5_init_cache(self.params, self.cfg, enc_out.shape[0],
                                 self.max_seq, enc_out, self.matmul_precision)

    # -- the own cache -------------------------------------------------------

    def _own_cache(self, rows: int) -> dict:
        """The runner's decoder cache, its cross buffers at least ``rows``
        long (grown, and its graphs dropped, past enc_capacity)."""
        if self._own is not None and rows <= self.enc_capacity:
            return self._own
        if rows > self.enc_capacity:
            self.enc_capacity = rows
        cfg, dev = self.cfg, self.device
        nh, hd = cfg.num_heads, cfg.head_dim
        n = len(self.params["dec"]["layers"])

        def zeros(s):
            return torch.zeros((1, s, nh, hd), dtype=torch.float32,
                               device=dev)

        self._own = {
            "cache": {"k": [zeros(self.max_seq + 1) for _ in range(n)],
                      "v": [zeros(self.max_seq + 1) for _ in range(n)],
                      "ck": [zeros(self.enc_capacity) for _ in range(n)],
                      "cv": [zeros(self.enc_capacity) for _ in range(n)]},
            "mask": torch.zeros((1, self.enc_capacity), dtype=torch.bool,
                                device=dev),
            "io": torch.zeros(3, dtype=torch.int32, device=dev),
        }
        self._graphs.clear()
        self._pool = None
        return self._own

    @torch.no_grad()
    def begin(self, ids: list[int]) -> dict:
        """Encode ``ids`` and load the runner's own decoder cache for them
        in place: the self cache zeroed, each layer's cross K/V copied in
        (rows past the input zeroed) and the mask set. Returns the cache
        session that ``step_host`` takes."""
        with self._lock:
            enc_out, mask = self._encode(ids)
            s_enc = enc_out.shape[1]
            own = self._own_cache(s_enc)
            cache = own["cache"]
            for buf in cache["k"] + cache["v"]:
                buf.zero_()
            ck, cv = t5_cross_kv(self.params, self.cfg, enc_out,
                                 self.matmul_precision)
            for bufs, src in ((cache["ck"], ck), (cache["cv"], cv)):
                for buf, val in zip(bufs, src):
                    buf[:, :s_enc].copy_(val)
                    buf[:, s_enc:].zero_()
            own["mask"].zero_()
            own["mask"][:, :s_enc].copy_(mask)
            return own

    def session(self, ids: list[int]) -> dict:
        """A session on a cache of its own (``make_cache``): its steps run
        eagerly, the plain path the graphs are held against."""
        with self._lock:
            enc_out, mask = self._encode(ids)
            return {"cache": self.make_cache(enc_out), "mask": mask,
                    "io": None}

    def _forward(self, sess: dict, tok, pos, length) -> torch.Tensor:
        logits, _ = t5_decode_step(
            self.params, self.cfg, tok.view(1, 1), pos.view(1, 1),
            length.view(1), sess["cache"], sess["mask"],
            self.matmul_precision)
        return logits

    def _graph(self, sess: dict):
        key = ("t5", self.enc_capacity)
        g = self._graphs.get(key)
        if g is None:
            io = sess["io"]
            dummy = torch.tensor([0, self.max_seq, 0], dtype=torch.int32,
                                 device=self.device)  # the write dropped
            g = self._graphs[key] = self._capture(
                key, lambda: self._forward(sess, *dummy),
                lambda: self._forward(sess, *io), io)
        return g

    @torch.no_grad()
    def step_host(self, sess: dict, tok: int, t: int) -> np.ndarray:
        """One decoder step of token ``tok`` at position ``t`` (self length
        t + 1); the logits [V] f32 on the host. On CUDA with the own cache:
        a graph replay."""
        with self._lock:
            if self.device.type == "cuda" and sess is self._own:
                g = self._graph(sess)
                g.inputs.copy_(torch.tensor([tok, t, t + 1],
                                            dtype=torch.int32))
                self._replay(g)
                out = g.out
            else:
                if self.device.type == "cuda":
                    self.eager_steps += 1
                io = torch.tensor([tok, t, t + 1], dtype=torch.int32,
                                  device=self.device)
                out = self._forward(sess, *io)
            return out[0, 0].float().cpu().numpy()

    def generate_ids(self, ids: list[int], max_tokens: int,
                     eos_id: int | None = None, sample=None,
                     eager: bool = False,
                     record: list | None = None) -> list[int]:
        """Greedy (or ``sample(logits np [V]) -> id``) seq2seq generation.
        ``eager``: on a cache of its own, every step eager. ``record``: each
        step's logits are appended to it."""
        with self.stream:
            sess = self.session(ids) if eager else self.begin(ids)
            tok = self.cfg.decoder_start_token_id
            out: list[int] = []
            for t in range(min(max_tokens, self.max_seq - 1)):
                row = self.step_host(sess, tok, t)
                if record is not None:
                    record.append(row)
                tok = int(row.argmax()) if sample is None \
                    else int(sample(row))
                if eos_id is not None and tok == eos_id:
                    break
                out.append(tok)
            return out
