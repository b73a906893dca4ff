"""The row-mapped causal depthwise convolution: the kernel of
csrc/shortconv.cu and its plain PyTorch version.

    causal_conv(x, state, w, bias, n_valid, rows=None) -> out

x [G, T, C] float32 (padding tokens already zero), state [B, K-1, C]
float32 (a layer's conv windows, one per cache row, updated in place), w
[K, C], bias [C] or None, n_valid [G] the valid tokens of each input row (a
prefix of its T), rows [G] the cache row of each input row (the runner's
launch plan), or None for the identity (G = B). out[g, t] = sum_k w[k] *
seq[g, t + k] (+ bias), seq = [state[rows[g]] | x[g]]. An input row with a
valid token writes its new window, the last K-1 of its valid inputs after
the old window, to its cache row; a row with none (padding, or a launch's
spare place repeating its first row) writes nothing, so two input rows may
share a cache row as long as at most one of them is real.

LFM2's short conv (models/mamba.shortconv_layer) and the Mamba family's
mixers take it through models/mamba.causal_conv. On a CUDA tensor the
kernel runs (no fallback); on the CPU the plain version, which is the
oracle the kernel is tested against: the kernel rounds each product and sum
on its own, in the plain version's order, so the two agree bit for bit.
Each launch counts in ``ops/qmatmul.LAUNCHES["short_conv"]`` (and so in the
runner's graph credit); the device trace names the kernel
``short_conv_kernel<K>``.
"""

from __future__ import annotations

import ctypes

import torch

from . import qmatmul as Q

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"short_conv_launch": [_P] * 7 + [_I] * 4 + [_P]}
K_MAX = 8  # the most taps the kernel takes


def read_windows(state: torch.Tensor, rows: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The windows of a step's input rows: state [B, ...] gathered by the
    row map ``rows`` [G] (input row i is cache row rows[i]), or state itself
    without one."""
    return state if rows is None else state.index_select(0, rows.long())


def write_windows(state: torch.Tensor, new: torch.Tensor, real: torch.Tensor,
                  rows: torch.Tensor | None = None) -> None:
    """state[rows[i]] <- new[i], in place, for each input row i with
    ``real[i]`` (a valid token in the step); no other input row writes,
    neither padding nor a launch's spare place that repeats its first row,
    so the cache row a padding row shares with a real one gets the real
    row's value. Real rows map to distinct cache rows. Nothing is read on
    the host: each cache row takes the one real input row mapped to it, if
    any, and keeps its value otherwise."""
    shape = (-1,) + (1,) * (state.dim() - 1)
    if rows is None:
        state.copy_(torch.where(real.view(shape), new, state))
        return
    src = torch.arange(new.shape[0], device=state.device)
    writer = torch.full((state.shape[0],), -1, dtype=torch.long,
                        device=state.device)
    writer.scatter_reduce_(0, rows.long(), torch.where(real, src, -1),
                           reduce="amax")
    state.copy_(torch.where((writer >= 0).view(shape),
                            new[writer.clamp(min=0)], state))


def causal_conv_plain(x: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None, n_valid: torch.Tensor,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the windows gathered by the row map, the taps
    summed in order, the new windows written back for real rows alone
    (read_windows and write_windows)."""
    t = x.shape[1]
    seq = torch.cat([read_windows(state, rows), x], dim=1)  # [G, K-1+T, C]
    w = w.float()
    out = seq[:, 0:t] * w[0]
    for k in range(1, w.shape[0]):
        out = out + seq[:, k:k + t] * w[k]
    if bias is not None:
        out = out + bias.float()
    gidx = n_valid.long()[:, None] + torch.arange(state.shape[1],
                                                  device=x.device)[None]
    new = torch.gather(seq, 1, gidx[..., None].expand(-1, -1, seq.shape[-1]))
    write_windows(state, new, n_valid > 0, rows)
    return out


def _lib() -> ctypes.CDLL:
    """csrc/shortconv.cu's library, built at first use (never during a
    CUDA graph capture: the warm-up run before it builds)."""
    from ..utils import cuda_build

    lib = cuda_build.loaded("shortconv")
    if lib is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("csrc/shortconv.cu is not built: run the step "
                               "once before capturing it")
        lib = cuda_build.load("shortconv", SIGNATURES)
    return lib


def causal_conv(x: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None, n_valid: torch.Tensor,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """The conv of ``x`` with the windows of ``state`` in front (the module
    docstring): the kernel for a CUDA tensor, else the plain version."""
    if x.device.type == "cpu":
        return causal_conv_plain(x, state, w, bias, n_valid, rows)
    g, t, c = x.shape
    k = w.shape[0]
    if not 2 <= k <= K_MAX or tuple(w.shape) != (k, c) or \
            tuple(state.shape[1:]) != (k - 1, c):
        raise ValueError(f"short conv: taps {tuple(w.shape)} and windows "
                         f"{tuple(state.shape)} do not fit {c} channels "
                         f"(2 to {K_MAX} taps)")
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError("short conv: the windows must be contiguous float32")
    if rows is None and g != state.shape[0]:
        raise ValueError(f"short conv: {g} input rows over {state.shape[0]} "
                         "cache rows need a row map")
    x = x.float().contiguous()
    w = w.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    rc = _lib().short_conv_launch(
        x.data_ptr(), state.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, n_valid.data_ptr(),
        rows.data_ptr() if rows is not None else None, out.data_ptr(), g, t,
        c, k, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"short conv kernel launch failed: cudaError {rc}")
    Q.LAUNCHES["short_conv"] += 1
    Q.LAUNCHES_BY_PATH["short_conv cuda cores"] = \
        Q.LAUNCHES_BY_PATH.get("short_conv cuda cores", 0) + 1
    return out
