"""Kernel timing on a CUDA card with CUDA events.

Decode reads its weights cold, so every timed launch follows a 256 MB read
that evicts the 50 MB L2 cache of an H100: a loop of back-to-back launches
would keep a 37 MB weight in L2 and overstate its rate. The flush reads (a
sum over the buffer) rather than writes: a write would leave 50 MB of dirty
lines in L2, and the timed kernel would pay for writing them back to HBM
while it reads its own bytes.

No host work may fall between the two events. A wrapper's Python (shape
checks, the output's allocation, the ctypes call) runs after the first
event is enqueued; on a slow host the device would reach that event and
then wait for the launch, and the wait would count as kernel time. So a
device-side sleep (``torch.cuda._sleep``) is queued after the flush and
before the first event: the device is busy with it while the host enqueues
``fn``, and the window holds only ``fn``'s device work.
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


# Operation types that cost several passes of a peak: "bf16x3" is an
# f32-accurate product on the bf16 tensor cores, x split into three bf16
# parts (the least such a product costs), so 3 passes at the bf16 peak;
# "bf16x2" the same product rounded to a bf16 output, where two parts of x
# (16 bits of its mantissa) are enough.
PASSES = {"bf16x3": ("bf16", 3), "bf16x2": ("bf16", 2)}


def bound_ms(nbytes: int, ops: int, op_type: str,
             peaks: dict[str, float]) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their type ("f32",
    "bf16", "int8", or "bf16x3" / "bf16x2": 3 or 2 bf16 passes per
    operation); and which of the two ("bytes" or "operations") it is."""
    peak, passes = PASSES.get(op_type, (op_type, 1))
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = passes * ops / peaks[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """``once(fn)``: one launch's device time in ms, L2 flushed before it;
    ``ms(fn, iters)``: the median of ``iters`` such launches after two
    warm-up calls."""

    def __init__(self, flush_bytes: int = 256 << 20,
                 sleep_cycles: int = 4_000_000):
        import torch

        self.flush_buf = torch.zeros(flush_bytes // 4, dtype=torch.float32,
                                     device="cuda")
        # ~2 ms at the H100's 1.98 GHz boost clock: longer than the host
        # takes to enqueue one wrapper call. The grouped MoE wrappers run
        # their dispatch plan's ~20 torch ops first; with ~0.5 ms the
        # grouped product's wrapper timed 1.88 ms against 1.22 ms for its
        # launch alone (chip_smoke.py, H100 80GB HBM3, 700 W)
        self.sleep_cycles = sleep_cycles

    def once(self, fn: Callable[[], object]) -> float:
        import torch

        self.flush_buf.sum()
        torch.cuda._sleep(self.sleep_cycles)
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
