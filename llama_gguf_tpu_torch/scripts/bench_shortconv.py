"""The row-mapped short-conv kernel (csrc/shortconv.cu) on a CUDA card:
its device time against its byte bound, its plain PyTorch version and
PyTorch's depthwise ``conv1d`` (the library's conv over the same windows
and inputs, without the row map's gather and write-back), at
LFM2-24B-A2B's width (2,048 channels, 3 taps, 48 cache rows).

    python -m llama_gguf_tpu_torch.scripts.bench_shortconv

One JSON line a shape: ms of each (utils/timing.Timer: CUDA events, L2
flushed, the median of 20 launches), and the bound: the kernel's own f32
traffic (x read and y written once, each real row's window read and
written, the taps) over the card's memory rate, or its 2·taps operations
a value over the f32 peak, whichever is larger.
"""

import json
import subprocess

import torch

from llama_gguf_tpu_torch.ops import shortconv as SC
from llama_gguf_tpu_torch.utils.timing import Timer, bound_ms, card_peaks

C, TAPS, B = 2048, 3, 48
# (label, input rows G, tokens T, cache rows mapped): a decode launch over
# the whole batch (the identity), a 512-token prefill launch of one row,
# two rows of 256
SHAPES = [("decode 48x1", 48, 1, False), ("prefill 1x512", 1, 512, True),
          ("prefill 2x256", 2, 256, True)]


def main() -> None:
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    peaks = card_peaks(name)
    timer = Timer()
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, g, t, mapped in SHAPES:
        state = torch.randn(B, TAPS - 1, C, device=dev, generator=gen)
        w = torch.randn(TAPS, C, device=dev, generator=gen)
        x = torch.randn(g, t, C, device=dev, generator=gen)
        n_valid = torch.full((g,), t, dtype=torch.int32, device=dev)
        rows = (torch.arange(g, dtype=torch.int32, device=dev) * 5
                if mapped else None)
        work = state.clone()
        kernel = timer.ms(lambda: SC.causal_conv(x, work, w, None, n_valid,
                                                 rows), 20)
        plain = timer.ms(lambda: SC.causal_conv_plain(x, work, w, None,
                                                      n_valid, rows), 20)
        seq = torch.cat([state[:g], x], 1).transpose(1, 2).contiguous()
        taps = w.t().contiguous()[:, None, :]  # [C, 1, K]
        library = timer.ms(lambda: torch.nn.functional.conv1d(
            seq, taps, groups=C), 20)
        nbytes = (2 * g * t * C + 2 * g * (TAPS - 1) * C + TAPS * C) * 4
        bound, by = bound_ms(nbytes, 2 * TAPS * g * t * C, "f32", peaks)
        print(json.dumps({"shape": label, "card": name, "power_limit": limit,
                          "kernel_ms": kernel, "bound_ms": bound, "by": by,
                          "plain_ms": plain, "library_ms": library}),
              flush=True)


if __name__ == "__main__":
    main()
