"""The plain references that decide ``correct``: plain PyTorch, importing
nothing of ``repro_torch`` and nothing of JAX."""
