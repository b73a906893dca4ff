"""Kernel timing on a CUDA card with CUDA events.

Decode reads its weights cold, so every timed launch follows a 256 MB write
that evicts the 50 MB L2 cache of an H100: a loop of back-to-back launches
would keep a 37 MB weight in L2 and overstate its rate.
"""

from __future__ import annotations

from typing import Callable

# Published peaks by card name (NVIDIA data sheets; dense, no sparsity):
# memory bytes/s and operations/s by operand type. f32 is the CUDA cores'
# rate; bf16 and int8 are the tensor cores'.
CARD_PEAKS = (
    ("H200", dict(bytes=4.8e12, f32=67e12, bf16=989e12, int8=1979e12)),
    ("H100 NVL", dict(bytes=3.9e12, f32=60e12, bf16=835e12, int8=1670e12)),
    ("H100 PCIe", dict(bytes=2.0e12, f32=51e12, bf16=756e12, int8=1513e12)),
    ("H100", dict(bytes=3.35e12, f32=67e12, bf16=989e12, int8=1979e12)),
)


def card_peaks(name: str) -> dict[str, float]:
    """The peaks of the card called ``name`` (torch.cuda.get_device_name);
    raises for a card not in the table."""
    for frag, peaks in CARD_PEAKS:
        if frag in name:
            return peaks
    raise ValueError(f"no published peaks known for {name!r}")


def bound_ms(nbytes: int, ops: int, op_type: str,
             peaks: dict[str, float]) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their type; and which
    of the two ("bytes" or "operations") it is."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """``once(fn)``: one launch's device time in ms, L2 flushed before it;
    ``ms(fn, iters)``: the median of ``iters`` such launches after two
    warm-up calls."""

    def __init__(self, flush_bytes: int = 256 << 20):
        import torch

        self.flush_buf = torch.empty(flush_bytes, dtype=torch.uint8,
                                     device="cuda")

    def once(self, fn: Callable[[], object]) -> float:
        import torch

        self.flush_buf.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    def ms(self, fn: Callable[[], object], iters: int = 10) -> float:
        for _ in range(2):
            fn()
        return median([self.once(fn) for _ in range(iters)])


def median(values: list[float]) -> float:
    """The upper median (the middle element of the sorted list)."""
    return sorted(values)[len(values) // 2]
