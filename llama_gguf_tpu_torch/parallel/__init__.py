"""Tensor, data and expert parallelism on torch.distributed (port of
llama_gguf_tpu/parallel): the sharding plan (sharding.py), the cluster
runtime (multihost.py) and serving over a mesh (service.py)."""
