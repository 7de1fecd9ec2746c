"""The encoder-decoder family's frame arithmetic, copied from
:mod:`repro.models.encdec` (``FRAME_RATIO``, ``frames_len``): the roofline
analysis (``repro_torch.roofline.analysis``) sizes a seamless model's
encoder input with it. The family itself is not ported yet (ROADMAP.md)."""
from __future__ import annotations

FRAME_RATIO = 4  # target tokens per encoder frame (fbank subsampling stub)


def frames_len(seq_len: int) -> int:
    return max(8, seq_len // FRAME_RATIO)
