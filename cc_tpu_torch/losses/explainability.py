"""Explainability-mask regularizer (counterpart of
cc_tpu/losses/explainability.py; loss_functions.py:148-158)."""
from __future__ import annotations

import torch

from cc_tpu_torch.losses.charbonnier import mean32


def logical_or(a, b):
    """Soft OR: 1 - (1-a)(1-b) (loss_functions.py:157-158)."""
    return 1.0 - (1.0 - a) * (1.0 - b)


def explainability_loss(mask) -> torch.Tensor:
    """BCE(mask, 1) summed over scales, with torch BCE's log clamp at -100
    (loss_functions.py:148-155)."""
    if not isinstance(mask, (list, tuple)):
        mask = [mask]
    loss = 0.0
    for m in mask:
        floor = m.new_full((), -100.0)
        loss = loss + mean32(-torch.maximum(torch.log(m), floor))
    return loss
