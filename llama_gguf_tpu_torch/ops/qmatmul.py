"""Fused dequant-matmul: wrappers over the CUDA kernels of csrc/qmatmul.cu
and their plain PyTorch versions (port of llama_gguf_tpu/ops/qmatmul.py).

  * ``qmatmul(x, lin)``          — y = x @ W for a q4 or q8 QuantLinear
                                    (kernels "qmatmul_q4" and "qmatmul_q8",
                                    replacing _qmatmul_call's _q4_kernel and
                                    _q8_kernel);
  * ``qmatmul_glu(x, lin, act)`` — act(x @ W_gate) * (x @ W_up) over a fused
                                    [gate | up] QuantLinear (kernel
                                    "qmatmul_glu", replacing
                                    _qmatmul_glu_call's _glu_kernel).

A wrapper runs the plain version only when ``x`` lies on the CPU. For a CUDA
tensor it launches the kernel or raises; there is no fallback. ``LAUNCHES``
counts kernel launches, one per launch, so a run can show that its main path
went through the kernels. What bounds each kernel on the card and how its
design meets that is written at the top of csrc/qmatmul.cu.
"""

from __future__ import annotations

import ctypes

import torch

from .linear import QuantLinear, dequantize_weight

GLU_ACTS = ("silu", "gelu", "relu", "relu2", "swiglu_oai")

LAUNCHES = {"qmatmul_q4": 0, "qmatmul_q8": 0, "qmatmul_glu": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# -- plain versions -----------------------------------------------------------


def glu_combine(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """The gated-activation epilogue, f32 in/out (mirrors _glu_combine)."""
    if act == "swiglu_oai":  # gpt-oss clamped SwiGLU
        g = torch.clamp(g, max=7.0)
        u = torch.clamp(u, -7.0, 7.0)
        return (g * torch.sigmoid(1.702 * g)) * (u + 1.0)
    if act == "gelu":  # tanh approximation (ggml_gelu)
        c = 0.7978845608028654  # sqrt(2/pi)
        return 0.5 * g * (1.0 + torch.tanh(c * (g + 0.044715 * g * g * g))) * u
    if act == "relu":
        return torch.relu(g) * u
    if act == "relu2":
        return torch.square(torch.relu(g)) * u
    return g * torch.sigmoid(g) * u  # silu


def qmatmul_plain(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """Plain version of the q4/q8 kernels: dequantize W, then x @ W in f32."""
    return torch.matmul(x.float(), dequantize_weight(lin))


def qmatmul_glu_plain(x: torch.Tensor, lin: QuantLinear,
                      act: str) -> torch.Tensor:
    """Plain version of the GLU kernel."""
    f = lin.splits[0]
    y = qmatmul_plain(x, lin)
    return glu_combine(y[:, :f], y[:, f:], act)


# -- kernel launches ----------------------------------------------------------

_ARGTYPES_SET = False


def _lib() -> ctypes.CDLL:
    from ..utils.cuda_build import load

    global _ARGTYPES_SET
    lib = load("qmatmul")
    if not _ARGTYPES_SET:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmatmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.qmatmul_launch.restype = i
        lib.qmatmul_glu_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                           p]
        lib.qmatmul_glu_launch.restype = i
        _ARGTYPES_SET = True
    return lib


def _check(x: torch.Tensor, lin: QuantLinear) -> None:
    if lin.scales.dtype != torch.float32 or (
            lin.mins is not None and lin.mins.dtype != torch.float32):
        raise NotImplementedError(
            "bf16 scale panels are not supported by the CUDA kernels yet "
            "(ROADMAP queue 1); load with scale_dtype='float32'")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != lin.k:
        raise ValueError(f"x must be float32 [B, {lin.k}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    tensors = [lin.packed, lin.scales] + ([lin.mins] if lin.mins is not None
                                          else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"weight on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("weight panels must be contiguous")
    if lin.fmt not in ("q4", "q8") or lin.k % lin.group or lin.group % 2:
        raise ValueError(f"unsupported layout fmt={lin.fmt} k={lin.k} "
                         f"group={lin.group}")
    packed = ((torch.uint8, (lin.k // 2, lin.n)) if lin.fmt == "q4"
              else (torch.int8, (lin.k, lin.n)))
    if (lin.packed.dtype, tuple(lin.packed.shape)) != packed:
        raise ValueError(f"packed must be {packed}, got {lin.packed.dtype} "
                         f"{tuple(lin.packed.shape)}")
    panel = (lin.k // lin.group, lin.n)
    for t in tensors[1:]:
        if tuple(t.shape) != panel:
            raise ValueError(f"scale/min panels must be {panel}, got "
                             f"{tuple(t.shape)}")


def _vec_ok(lin: QuantLinear, cols: int, out: torch.Tensor) -> int:
    """1 when 4-column vector loads are legal: the column count is a
    multiple of 4 and every panel is 16-byte aligned."""
    ptrs = [lin.packed.data_ptr(), lin.scales.data_ptr(), out.data_ptr()]
    if lin.mins is not None:
        ptrs.append(lin.mins.data_ptr())
    return int(cols % 4 == 0 and all(p % 16 == 0 for p in ptrs))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def qmatmul(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """x [B, K] float32 @ quantized W [K, N] -> [B, N] float32 (bias NOT
    applied)."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, lin)
    if x.device.type != "cuda":
        raise RuntimeError(f"qmatmul: no kernel for device {x.device}")
    x = x.contiguous()
    _check(x, lin)
    b = x.shape[0]
    y = torch.empty((b, lin.n), dtype=torch.float32, device=x.device)
    if b == 0:
        return y
    fmt = 0 if lin.fmt == "q4" else 1
    rc = _lib().qmatmul_launch(
        x.data_ptr(), lin.packed.data_ptr(), lin.scales.data_ptr(),
        lin.mins.data_ptr() if lin.mins is not None else None, y.data_ptr(),
        b, lin.k, lin.n, lin.group, fmt, _vec_ok(lin, lin.n, y),
        _stream(x))
    _raise_on(rc, "qmatmul")
    LAUNCHES["qmatmul_q4" if fmt == 0 else "qmatmul_q8"] += 1
    return y


def qmatmul_glu(x: torch.Tensor, lin, act: str) -> torch.Tensor | None:
    """act(x @ W_gate) * (x @ W_up) for a FUSED gate/up QuantLinear (equal
    splits). Returns None where the JAX qmatmul_glu does (unknown act, a
    bias, no equal two-way split): the caller then takes the two-step
    path."""
    if act not in GLU_ACTS or lin.bias is not None:
        return None
    splits = getattr(lin, "splits", None)
    if not splits or len(splits) != 2 or splits[0] != splits[1]:
        return None
    if x.device.type == "cpu":
        return qmatmul_glu_plain(x, lin, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"qmatmul_glu: no kernel for device {x.device}")
    x = x.contiguous()
    _check(x, lin)
    b, f = x.shape[0], splits[0]
    y = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0:
        return y
    rc = _lib().qmatmul_glu_launch(
        x.data_ptr(), lin.packed.data_ptr(), lin.scales.data_ptr(),
        lin.mins.data_ptr() if lin.mins is not None else None, y.data_ptr(),
        b, lin.k, f, lin.group, 0 if lin.fmt == "q4" else 1,
        GLU_ACTS.index(act), _vec_ok(lin, f, y), _stream(x))
    _raise_on(rc, "qmatmul_glu")
    LAUNCHES["qmatmul_glu"] += 1
    return y
