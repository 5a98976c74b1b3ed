"""Plain references that decide `correct`: plain PyTorch, importing nothing
of the port (`repro_torch`), of the JAX package or of JAX."""
