"""The H100 benchmark of llama_gguf_tpu_torch (see bench_h100/README.md).

The yardstick lives here: traffic generation, the weights a run makes, the
reduction of spans and profiler traces to metrics, the roofline reckoning
and the comparison that decides ``correct``. From the port it takes only
the system under test (``Engine``/``BatchedEngine``/``ModelRunner``), and
the profiler's kernel names.
"""
