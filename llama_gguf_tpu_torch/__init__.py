"""llama_gguf_tpu_torch: the PyTorch/CUDA port of llama_gguf_tpu.

GGUF models load with ``Engine.load(path, device="cuda")`` and generate with
``Engine.generate``; the quantized matmuls run through hand-written CUDA
kernels for Hopper (csrc/qgemm.cu, csrc/moe_qmatmul.cu). The package
imports torch and numpy, never jax and nothing of llama_gguf_tpu; module
names mirror that package's.
"""

__version__ = "0.1.0"
