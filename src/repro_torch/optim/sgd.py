"""Plain SGD (the paper, γ=0.01) on dicts of tensors."""
from __future__ import annotations

from typing import Dict

import torch


def sgd_update(
    params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float
) -> Dict[str, torch.Tensor]:
    return {k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}
