"""On-device kernel parity gate: the dequant-matmul kernels of csrc/qgemm.cu
against their plain PyTorch versions on the card (port of
llama_gguf_tpu/ops/parity.py).

The CPU tests reach only the kernels' plain versions and their arithmetic
written in torch; a kernel that builds but computes another layout wrongly
would pass them. These gates run every layout of a loaded model through its
kernel on the card before anything is timed. There is no kernel on the CPU,
so on the CPU they raise rather than pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .linear import QuantExpertStack, QuantLinear
from . import qmatmul as Q

# decode (split-K) and a prefill-sized tile (tensor cores where the layout
# takes them): both paths of every layout
GATE_ROWS = (1, 8)
# f32 outputs, and bf16 outputs as the serving configuration runs them
GATE_PRECISIONS = ("highest", "default")


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{what}: the weights are on {t.device}; the gate holds the "
            "kernels against their plain versions on the card, and there "
            "is no kernel on the CPU")


def _collect(tree, seen: dict) -> None:
    if isinstance(tree, QuantLinear):
        glu = (tree.bias is None and len(tree.splits or ()) == 2
               and tree.splits[0] == tree.splits[1])
        key = (tree.fmt, tree.group, tree.source_type,
               str(tree.scales.dtype)[6:], glu)
        seen.setdefault(key, tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, seen)


def _diverges(got: torch.Tensor, want: torch.Tensor, rtol: float,
              atol: float) -> tuple[bool, float]:
    """|got - want| > atol * max |want| + rtol * |want| anywhere, beyond one
    bf16 ulp of |want| for a "default"-precision (bf16) output: the same f32
    sums rounded once after another order of summation."""
    slack = Q.bf16_ulp(want) if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max()) / scale
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= slack + atol * scale + rtol * want.abs()).all())
    return not ok, err


def kernel_parity_check(params, rtol: float = 2e-2,
                        atol: float = 2e-2) -> int:
    """Run every distinct QuantLinear (fmt, group, source_type, panel dtype)
    of ``params`` through kernel 1 or 2 (``qmatmul``) at GATE_ROWS rows, and
    a fused gate|up weight also through the GLU kernel 3, against the plain
    versions on the same inputs, in each of GATE_PRECISIONS ("highest": f32
    outputs; "default", as the serving configuration runs: bf16 outputs);
    raise AssertionError on divergence (see _diverges). Returns the number
    of layouts checked. Raises RuntimeError on weights that are not on the
    card."""
    seen: dict[tuple, QuantLinear] = {}
    _collect(params, seen)
    rng = np.random.default_rng(1234)
    for (fmt, group, src, panel, glu), lin in seen.items():
        _on_card(lin.packed, "kernel_parity_check")
        for rows in GATE_ROWS:
            x = torch.from_numpy(rng.normal(size=(rows, lin.k)).astype(
                np.float32)).to(lin.packed.device)
            for precision in GATE_PRECISIONS:
                pairs = [("qmatmul", Q.qmatmul(x, lin, precision),
                          Q.qmatmul_plain(x, lin, precision))]
                if glu:
                    pairs.append((
                        "qmatmul_glu",
                        Q.qmatmul_glu(x, lin, "silu", precision),
                        Q.qmatmul_glu_plain(x, lin, "silu", precision)))
                for name, got, want in pairs:
                    bad, err = _diverges(got, want, rtol, atol)
                    if bad:
                        raise AssertionError(
                            f"{name} diverges from its plain version for fmt="
                            f"{fmt} group={group} src={src} panels={panel} "
                            f"rows={rows} precision={precision}: max rel err "
                            f"{err:.2e}")
    return len(seen)


def expert_arrays(rng, ggml_type, e_num: int, k: int, n: int,
                  scale: float = 0.1) -> dict:
    """``e_num`` experts of seeded normal [n, k] weights times ``scale``,
    quantized to ``ggml_type`` and repacked as the loader repacks an expert
    stack: the stacked host arrays by field ("packed", "scales", and "mins"
    where the layout has them) and the layout ("fmt", "group")."""
    from ..quant.quantize import quantize
    from ..quant.repack import repack

    rws = [repack(quantize(rng.standard_normal((n, k), dtype=np.float32)
                           * scale, ggml_type), ggml_type, (n, k))
           for _ in range(e_num)]
    out = {"fmt": rws[0].fmt, "group": rws[0].group}
    for field in ("packed", "scales", "mins"):
        if getattr(rws[0], field) is not None:
            out[field] = np.stack([getattr(r, field) for r in rws])
    return out


def _stack(rng, ggml_type, e_num: int, k: int, n: int,
           device) -> QuantExpertStack:
    a = expert_arrays(rng, ggml_type, e_num, k, n)
    put = lambda key: (torch.from_numpy(a[key]).to(device)  # noqa: E731
                       if key in a else None)
    return QuantExpertStack(put("packed"), put("scales"), put("mins"),
                            fmt=a["fmt"], group=a["group"], k=k, n=n)


def moe_kernel_parity_check(ggml_type=None, rtol: float = 2e-2,
                            atol: float = 2e-2) -> int:
    """The MoE kernels on the card against their plain versions on a small
    synthetic expert stack of ``ggml_type`` (default Q4_K; E = 2, K = 256, N
    = 128), in each of GATE_PRECISIONS: the slot-major kernel 4 at 4 slots,
    the grouped kernel 5 and the grouped GLU kernel 6 (a distinct up stack,
    so a swap of the halves fails) at 37 slots. Raises AssertionError on
    divergence, RuntimeError where there is no card. Returns the number of
    products checked."""
    from ..gguf.constants import GGMLType

    if not torch.cuda.is_available():
        raise RuntimeError(
            "moe_kernel_parity_check: the gate holds the MoE kernels against "
            "their plain versions on the card, and there is no kernel on the "
            "CPU")
    dev = torch.device("cuda")
    ggml_type = GGMLType.Q4_K if ggml_type is None else GGMLType(ggml_type)
    rng = np.random.default_rng(7)
    e_num, k, n = 2, 256, 128
    gate = _stack(rng, ggml_type, e_num, k, n, dev)
    up = _stack(rng, ggml_type, e_num, k, n, dev)
    checks = 0
    for s_slots in (4, Q.MOE_GROUPED_MIN_SLOTS + 5):
        x = torch.from_numpy(rng.standard_normal((s_slots, k)).astype(
            np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, e_num, size=s_slots).astype(
            np.int32)).to(dev)
        for precision in GATE_PRECISIONS:
            pairs = [("moe_qmatmul", Q.moe_qmatmul(x, gate, idx, precision),
                      Q.moe_qmatmul_plain(x, gate, idx, precision))]
            if Q.moe_dims(s_slots, e_num)[2]:
                pairs.append((
                    "moe_qmatmul_glu",
                    Q.moe_qmatmul_glu(x, gate, up, idx, "silu", precision),
                    Q.moe_qmatmul_glu_plain(x, gate, up, idx, "silu",
                                            precision)))
            for name, got, want in pairs:
                bad, err = _diverges(got, want, rtol, atol)
                if bad:
                    raise AssertionError(
                        f"{name} (S={s_slots}, {ggml_type.name}, {precision}) "
                        f"diverges from its plain version: max rel err "
                        f"{err:.2e}")
                checks += 1
    return checks
