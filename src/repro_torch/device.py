"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``cuda`` is the default of every entry point; on a machine without a
    usable GPU it raises instead of carrying on on the CPU — the CPU path
    is taken only when the caller asks for it with ``device="cpu"``.

    On CUDA it also turns TF32 off for float32 matrix products and
    convolutions: the port is held against the JAX reference at float32
    tolerances, and TF32 keeps about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device 'cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
