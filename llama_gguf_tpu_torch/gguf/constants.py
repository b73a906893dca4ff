"""GGUF file-format and GGML tensor-type constants.

Re-derived from the public GGUF spec / llama.cpp type tables. A copy of
llama_gguf_tpu/gguf/constants.py: the PyTorch port keeps its own so that it
never imports the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_DEFAULT_ALIGNMENT = 32

# Metadata value types (GGUF spec).
class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# GGML tensor dtypes (ids fixed by the ggml format).
class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3, removed from the format
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


QK_K = 256  # super-block size for K-quants


@dataclass(frozen=True)
class TypeTraits:
    """Block layout of one GGML dtype: elements per block and bytes per block."""

    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool


# (block elements, block bytes). Byte counts are the sum of the block struct
# fields (llama.cpp's block structs).
TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    GGMLType.Q4_0: TypeTraits(32, 18, True),  # f16 d + 16B nibbles
    GGMLType.Q4_1: TypeTraits(32, 20, True),  # f16 d,m + 16B nibbles
    GGMLType.Q5_0: TypeTraits(32, 22, True),  # f16 d + u32 qh + 16B nibbles
    GGMLType.Q5_1: TypeTraits(32, 24, True),  # f16 d,m + u32 qh + 16B
    GGMLType.Q8_0: TypeTraits(32, 34, True),  # f16 d + 32 i8
    GGMLType.Q8_1: TypeTraits(32, 36, True),  # f16 d,s + 32 i8
    GGMLType.Q2_K: TypeTraits(QK_K, 84, True),  # scales[16] qs[64] d dmin
    GGMLType.Q3_K: TypeTraits(QK_K, 110, True),  # hmask[32] qs[64] scales[12] d
    GGMLType.Q4_K: TypeTraits(QK_K, 144, True),  # d dmin scales[12] qs[128]
    GGMLType.Q5_K: TypeTraits(QK_K, 176, True),  # d dmin scales[12] qh[32] qs[128]
    GGMLType.Q6_K: TypeTraits(QK_K, 210, True),  # ql[128] qh[64] scales[16] d
    GGMLType.Q8_K: TypeTraits(QK_K, 292, True),  # f32 d + qs[256] + bsums[16]i16
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 66, True),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 74, True),
    GGMLType.IQ2_S: TypeTraits(QK_K, 82, True),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 98, True),
    GGMLType.IQ3_S: TypeTraits(QK_K, 110, True),
    GGMLType.IQ1_S: TypeTraits(QK_K, 50, True),
    GGMLType.IQ1_M: TypeTraits(QK_K, 56, True),
    GGMLType.IQ4_NL: TypeTraits(32, 18, True),  # f16 d + 16B nibble idx
    GGMLType.IQ4_XS: TypeTraits(QK_K, 136, True),  # d scales_h scales_l[4] qs[128]
}


def type_traits(t: GGMLType | int) -> TypeTraits:
    return TYPE_TRAITS[GGMLType(t)]


def tensor_nbytes(ggml_type: GGMLType | int, n_elements: int) -> int:
    tr = type_traits(ggml_type)
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{GGMLType(ggml_type).name}: {n_elements} elements not divisible "
            f"by block size {tr.block_size}"
        )
    return (n_elements // tr.block_size) * tr.type_size


# Common GGUF metadata keys.
KEY_GENERAL_ARCHITECTURE = "general.architecture"
KEY_GENERAL_NAME = "general.name"
KEY_GENERAL_ALIGNMENT = "general.alignment"
KEY_GENERAL_QUANT_VERSION = "general.quantization_version"
KEY_GENERAL_FILE_TYPE = "general.file_type"


def align_offset(offset: int, alignment: int = GGUF_DEFAULT_ALIGNMENT) -> int:
    """Round ``offset`` up to a multiple of ``alignment``."""
    return offset + (alignment - offset % alignment) % alignment
