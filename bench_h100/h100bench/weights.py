"""A configuration's weights and GGUF, made from ``--seed``.

The family module (bench_h100/reference/<family>.py) gives the GGUF layout;
this file fills it with random blocks on the run's device and writes the
file. The same host bytes are handed to the reference after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ggml

BANNED = (1, 2)  # <s>, </s>: control ids, which decode to no text


def tokenizer_metadata(vocab: int) -> dict:
    """A plain tokenizer over the whole vocabulary: every id but the two
    control ids decodes to non-empty text, so each served token is one
    streamed piece."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(3, vocab)]
    types = np.ones(vocab, np.int32)
    types[0], types[1], types[2] = 2, 3, 3
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.zeros(vocab, np.float32),
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.add_bos_token": False}


def make(cfg: dict, family, seed: int, device) -> tuple[dict, list]:
    """(metadata, [ggml.Tensor]) of ``cfg``: random blocks for the quantized
    tensors, 1 + N(0, 0.02) norms, N(0, 0.02) routers, N(0, 0.05) biases,
    from one generator on ``device`` seeded by ``seed``."""
    md, specs = family.layout(cfg)
    md.update(tokenizer_metadata(cfg["vocab_size"]))
    std = float(cfg["assumed"]["weight_std"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tensors = []
    for name, shape, fmt, init in specs:
        if init == "quant":
            fmt = ggml.pick_format(fmt, shape[-1])
            raw = ggml.random_blocks(fmt, shape, std, gen, device)
        else:
            mean, s = {"norm": (1.0, 0.02), "router": (0.0, 0.02),
                       "bias": (0.0, 0.05)}[init]
            raw = ggml.random_f32(shape, mean, s, gen, device)
        tensors.append(ggml.Tensor(name, tuple(shape), fmt,
                                   raw.cpu().numpy()))
    return md, tensors


def weight_bytes(tensors) -> int:
    return sum(t.data.nbytes for t in tensors)
