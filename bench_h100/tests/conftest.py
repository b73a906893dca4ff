"""The benchmark's own tests: ``python -m pytest bench_h100/tests -q`` from
the root of the checkout (the tests marked ``cuda`` skip without a card).
They import the harness as the benchmark does: bench_h100/ and the
checkout's root on the path."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("LLAMA_GGUF_NO_REPACK_CACHE", "1")


def tiny(name: str) -> dict:
    with open(os.path.join(HERE, "tiny", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
