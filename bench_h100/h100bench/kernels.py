"""Profiler kernel names -> the port's kernels 1-6 (a copy of chip_smoke.py's
``kernel_key`` reading, kept with the yardstick).

csrc/qgemm.cu's ``qgemm_tc`` and ``qgemm_splitk``: the first template
argument is the weight format (0 = q4), the last the kind (bit flags GLU 1,
GATHERED 2, SLOT 4). csrc/moe_qmatmul.cu's ``moe_grouped_kernel<FMT, NW,
...>``: NW 1 the grouped product (kernel 5), 2 the grouped GLU (kernel 6).
"""

from __future__ import annotations

_KIND = {"1": 3, "4": 4, "2": 5, "3": 6}


def _args(name: str, kern: str) -> list[str]:
    return [a.strip() for a in
            name.split(kern, 1)[1].split(">", 1)[0].split(",")]


def kernel_of(name: str) -> int | None:
    """The kernel number (1 q4 product, 2 q8 product, 3 GLU, 4 per-slot
    MoE, 5 grouped MoE, 6 grouped MoE GLU) of a device op, or None."""
    for kern in ("qgemm_tc<", "qgemm_splitk<"):
        if kern in name:
            args = _args(name, kern)
            return _KIND.get(args[-1], 1 if args[0] == "0" else 2)
    if "moe_grouped_kernel<" in name:
        return 6 if _args(name, "moe_grouped_kernel<")[1] == "2" else 5
    return None


def label(name: str) -> str:
    """A short name for the breakdown."""
    k = kernel_of(name)
    if k is not None:
        path = ("tensor cores" if "qgemm_tc<" in name else "split-K"
                if "qgemm_splitk<" in name else "CUDA cores")
        return f"kernel {k} ({path})"
    return name if len(name) <= 80 else name[:77] + "..."
