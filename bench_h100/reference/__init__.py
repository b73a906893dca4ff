"""Plain references, one module per model family: the GGUF layout, the
roofline's attention reckoning and a float32 forward pass. They import
nothing of the port and nothing of JAX."""
