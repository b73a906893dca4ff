"""The H100 benchmark of llama_gguf_tpu_torch: one run of one cell.

    python3 bench_h100/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (BENCHMARK.json names the cells). Prints
progress and the compared numbers on stderr and, last on stdout, one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1 the
breakdown), then the compared numbers with their limits. Exits non-zero,
printing no result, without enough CUDA cards, when JAX or the JAX
package was loaded, or when a CUDA graph was captured inside the window.
``--control 1`` judges the float8 control in the program's place, so that
``correct`` reads false (never in the benchmark's own runs).
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)

# the GGUF is written anew by every run and deleted at exit: no repack
# sidecar beside it. Kernel caches stay inside the checkout, at fixed paths
# (the port builds its own under .cache/ there already)
os.environ["LLAMA_GGUF_NO_REPACK_CACHE"] = "1"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from h100bench.bench import WindowCaptured, cell_files, run_cell
    from h100bench.guard import loaded

    cell, cfg, spec = cell_files(HERE, bench, args.workload)
    try:
        result, compared = run_cell(HERE, bench, cell, cfg, spec, args.seed,
                                    args.seconds, bool(args.trace), "cuda",
                                    T_START, control=bool(args.control))
    except WindowCaptured as e:
        print(f"refused: {e}", file=sys.stderr)
        return 5
    bad = loaded()
    if bad:
        print(f"the run loaded {', '.join(bad)}: refused", file=sys.stderr)
        return 4
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(obj):
    """The result with every non-finite number as null (a metric that read
    none is left out)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        out = {k: _finite(v) for k, v in obj.items()}
        if "metrics" in out:
            out["metrics"] = {k: v for k, v in out["metrics"].items()
                              if v["value"] is not None}
        return out
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


if __name__ == "__main__":
    sys.exit(main())
