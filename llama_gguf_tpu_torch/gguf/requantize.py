"""Whole-model re-quantization between GGUF formats.

A copy of llama_gguf_tpu/gguf/requantize.py (the port never imports the JAX
package); its output file is byte-identical to the JAX one. Copies the
metadata, dequantizes each tensor to f32 and requantizes it to the target
type, skipping small tensors, 1D tensors (norms, biases) and, with
``weights_only``, the embeddings and output head; a row whose length does
not divide the target's block size falls back to f16.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..quant.dequant import dequantize
from ..quant.quantize import quantize, supported_quant_types
from .constants import GGMLType, type_traits
from .reader import GGUFFile
from .writer import GGUFWriter

log = logging.getLogger(__name__)

# tensor-name suffixes that stay in high precision with weights_only
_PROTECTED_SUFFIXES = (
    "norm.weight", "norm.bias", ".bias", "sinks",
)
_EMBED_NAMES = ("token_embd.weight", "output.weight", "position_embd.weight",
                "token_types.weight")


@dataclass
class QuantizeOptions:
    target: GGMLType = GGMLType.Q4_K
    weights_only: bool = True     # keep embeddings/output in higher precision
    min_elements: int = 1024      # don't requantize tiny tensors
    embed_type: GGMLType | None = None  # type for embeddings when not protected


@dataclass
class QuantizeReport:
    converted: int = 0
    skipped: int = 0
    fallback_f16: int = 0
    in_bytes: int = 0
    out_bytes: int = 0
    per_tensor: list[tuple[str, str, str]] = field(default_factory=list)


def _target_for(name: str, shape: tuple[int, ...], ggml_type: GGMLType,
                opts: QuantizeOptions) -> GGMLType | None:
    """Decide the output type for one tensor; None = copy unchanged."""
    n = int(np.prod(shape)) if shape else 0
    if len(shape) < 2 or n < opts.min_elements:
        return None
    if any(name.endswith(s) for s in _PROTECTED_SUFFIXES):
        return None
    if name in _EMBED_NAMES and opts.weights_only:
        if opts.embed_type is not None:
            return opts.embed_type
        return None
    tgt = opts.target
    row = shape[-1]  # numpy row length = GGUF ne[0]
    if row % type_traits(tgt).block_size != 0:
        return GGMLType.F16  # block-size fallback (parity: quantize.rs policy)
    return tgt


def quantize_model(in_path: str, out_path: str,
                   opts: QuantizeOptions | None = None,
                   progress: Callable[[str, int, int], None] | None = None,
                   ) -> QuantizeReport:
    """Requantize a whole GGUF model file. Returns a per-tensor report."""
    opts = opts or QuantizeOptions()
    if opts.target not in supported_quant_types():
        raise ValueError(f"unsupported target type {opts.target.name}")
    src = GGUFFile.open(in_path)
    report = QuantizeReport()
    try:
        w = GGUFWriter(alignment=src.alignment)
        for key, value in src.metadata.items():
            if key == "general.file_type":
                continue  # rewritten below
            w.add_metadata(key, value)
        w.add_metadata("general.file_type", _file_type_code(opts.target))

        total = len(src.tensor_order)
        for i, name in enumerate(src.tensor_order):
            info = src.tensors[name]
            raw = src.tensor_bytes(name)
            report.in_bytes += info.nbytes
            tgt = _target_for(name, info.np_shape, info.ggml_type, opts)
            if tgt is None or tgt == info.ggml_type:
                w.add_tensor_raw(name, info.shape, info.ggml_type,
                                 bytes(raw))
                report.skipped += 1
                report.out_bytes += info.nbytes
                report.per_tensor.append(
                    (name, info.ggml_type.name, info.ggml_type.name))
            else:
                f32 = dequantize(raw, info.ggml_type, info.np_shape)
                packed = quantize(f32, tgt)
                w.add_tensor_raw(name, info.shape, tgt, packed.tobytes())
                report.converted += 1
                if tgt == GGMLType.F16 and opts.target != GGMLType.F16:
                    report.fallback_f16 += 1
                report.out_bytes += packed.nbytes
                report.per_tensor.append(
                    (name, info.ggml_type.name, tgt.name))
            if progress:
                progress(name, i + 1, total)
        w.write_to_path(out_path)
    finally:
        src.close()
    log.info("requantized %s -> %s: %d converted, %d kept, %.2fx size",
             in_path, out_path, report.converted, report.skipped,
             report.in_bytes / max(report.out_bytes, 1))
    return report


def _file_type_code(t: GGMLType) -> int:
    """llama.cpp general.file_type codes for the common targets."""
    return {
        GGMLType.F32: 0, GGMLType.F16: 1, GGMLType.Q4_0: 2, GGMLType.Q4_1: 3,
        GGMLType.Q8_0: 7, GGMLType.Q5_0: 8, GGMLType.Q5_1: 9,
        GGMLType.Q2_K: 10, GGMLType.Q3_K: 12, GGMLType.Q4_K: 15,
        GGMLType.Q5_K: 17, GGMLType.Q6_K: 18, GGMLType.IQ4_NL: 25,
        GGMLType.IQ4_XS: 30, GGMLType.BF16: 32,
    }.get(t, 0)
