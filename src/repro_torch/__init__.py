"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, slice by slice.

It mirrors the JAX package's layout and names (``repro_torch.models.
transformer`` is the counterpart of ``repro.models.transformer``) and
imports ``torch`` and numpy only: nothing of JAX and nothing of ``repro``.
Modules without JAX that the port needs are kept here as copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); on the CPU every kernel
wrapper computes its plain PyTorch version instead of launching.
"""
