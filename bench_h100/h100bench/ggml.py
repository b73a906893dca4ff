"""GGML block formats, random quant blocks made from a seed, and a GGUF v3
writer.

Weights are random blocks made directly as block bytes on the run's device
(one ``torch.Generator`` seeded from ``--seed``, a few large calls), with
each block's float fields set to fixed values so that the dequantized
weights have a standard deviation near ``std`` and a mean near 0. No float
weight is quantized, so making two gigabytes takes seconds.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

F32, Q5_1, Q4_K, Q6_K = 0, 7, 12, 14
# type id -> (weights per block, bytes per block)
BLOCK = {F32: (1, 4), Q5_1: (32, 24), Q4_K: (256, 144), Q6_K: (256, 210)}
NAMES = {F32: "F32", Q5_1: "Q5_1", Q4_K: "Q4_K", Q6_K: "Q6_K"}

GGUF_MAGIC = 0x46554747
ALIGN = 32


def block_bytes(fmt: int, n_weights: int) -> int:
    """Bytes of ``n_weights`` weights in format ``fmt``."""
    per, nbytes = BLOCK[fmt]
    if n_weights % per:
        raise ValueError(f"{n_weights} weights do not fill {NAMES[fmt]} blocks")
    return n_weights // per * nbytes


def pick_format(fmt: int, k: int) -> int:
    """The format a row of ``k`` weights is stored in: a K-quant whose
    256-weight super-block does not divide the row falls back to Q5_1, as
    llama.cpp's Q4_K_M mix (and the port's synthetic presets) do."""
    if fmt in (Q4_K, Q6_K) and k % 256 and k % 32 == 0:
        return Q5_1
    if fmt != F32 and k % BLOCK[fmt][0]:
        raise ValueError(f"rows of {k} do not fit {NAMES[fmt]}")
    return fmt


def _f16_bytes(value: float) -> tuple[int, int]:
    b = np.array([value], np.float16).view(np.uint8)
    return int(b[0]), int(b[1])


def _set_f16(blocks: torch.Tensor, offset: int, value: float) -> None:
    lo, hi = _f16_bytes(value)
    blocks[:, offset] = lo
    blocks[:, offset + 1] = hi


def random_blocks(fmt: int, shape: tuple[int, ...], std: float,
                  gen: torch.Generator, device) -> torch.Tensor:
    """Random blocks of a tensor of numpy ``shape`` (rows along the last
    axis) as a flat uint8 tensor on ``device``. Q4_K: w = d·sc·q − dmin·m
    with random 6-bit sc, m and 4-bit q, dmin = 7.5·d (mean ≈ 0), std ≈
    257·d. Q6_K: w = d·sc·(q − 32), random int8 sc and 6-bit q, std ≈
    1366·d. Q5_1: w = d·q + m, 5-bit q, m = −15.5·d, std ≈ 9.23·d."""
    n = int(np.prod(shape))
    per, nbytes = BLOCK[fmt]
    nblk = n // per
    raw = torch.randint(0, 256, (nblk, nbytes), dtype=torch.uint8,
                        generator=gen, device=device)
    if fmt == Q4_K:
        d = std / 257.0
        _set_f16(raw, 0, d)
        _set_f16(raw, 2, 7.5 * d)
    elif fmt == Q6_K:
        _set_f16(raw, 208, std / 1366.0)
    elif fmt == Q5_1:
        d = std / 9.23
        _set_f16(raw, 0, d)
        _set_f16(raw, 2, -15.5 * d)
    else:
        raise ValueError(f"no random blocks for type {fmt}")
    return raw.reshape(-1)


def random_f32(shape: tuple[int, ...], mean: float, std: float,
               gen: torch.Generator, device) -> torch.Tensor:
    """A float tensor (norm weights, routers, biases) as flat uint8 bytes."""
    t = torch.randn(shape, generator=gen, device=device) * std + mean
    return t.reshape(-1).view(torch.uint8)


@dataclass
class Tensor:
    """One tensor of a GGUF: numpy ``shape`` (rows along the last axis),
    type id, and its bytes (a uint8 numpy array)."""
    name: str
    shape: tuple[int, ...]
    fmt: int
    data: np.ndarray


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _value(v) -> bytes:
    """(type id, packed value) of a metadata value."""
    if isinstance(v, bool):
        return struct.pack("<I", 7) + struct.pack("<B", int(v))
    if isinstance(v, int):
        return struct.pack("<I", 4) + struct.pack("<I", v) if v >= 0 else \
            struct.pack("<I", 5) + struct.pack("<i", v)
    if isinstance(v, float):
        return struct.pack("<I", 6) + struct.pack("<f", v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + _str(v)
    if isinstance(v, np.ndarray):
        code = {np.dtype(np.float32): 6, np.dtype(np.int32): 5}[v.dtype]
        return (struct.pack("<I", 9) + struct.pack("<IQ", code, v.size)
                + np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<"))
                .tobytes())
    if isinstance(v, list) and all(isinstance(x, str) for x in v):
        return (struct.pack("<I", 9) + struct.pack("<IQ", 8, len(v))
                + b"".join(_str(x) for x in v))
    raise TypeError(f"no GGUF encoding for {type(v).__name__}")


def write_gguf(path: str, metadata: dict, tensors: list[Tensor]) -> int:
    """Write a GGUF v3 file; returns the bytes written."""
    head = [struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata))]
    for key, v in metadata.items():
        head.append(_str(key) + _value(v))
    offset = 0
    offsets = []
    for t in tensors:
        offsets.append(offset)
        dims = tuple(reversed(t.shape))
        head.append(_str(t.name) + struct.pack("<I", len(dims))
                    + b"".join(struct.pack("<Q", d) for d in dims)
                    + struct.pack("<IQ", t.fmt, offset))
        offset += -(-t.data.nbytes // ALIGN) * ALIGN
    header = b"".join(head)
    pad = -len(header) % ALIGN
    with open(path, "wb") as f:
        f.write(header + b"\0" * pad)
        for t, off in zip(tensors, offsets):
            f.write(memoryview(t.data))
            f.write(b"\0" * (-t.data.nbytes % ALIGN))
        return f.tell()
