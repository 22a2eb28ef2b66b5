"""The paper's client model (§V): 6 conv layers, 3 max-pools, 3 FC layers.

Functional PyTorch on a dict of tensors keyed like ``repro.models.cnn``'s
params (``conv{i}_w``, ``conv{i}_b``, ``fc{i}_w``, ``fc{i}_b``).  Conv weights
are stored OIHW (PyTorch's layout; ``checkpoint/convert.py`` maps the
reference's HWIO), FC weights (in, out) as in the reference.  Images stay NHWC
at every public function and are permuted once inside :func:`forward`, which
permutes back to NHWC before the flatten so ``fc0_w``'s rows keep the
reference's (h, w, c) order.  ``feature_vector`` taps the output layer
(10 logits -> softmax), the paper's VAoI proxy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.models.common import Params, softmax_cross_entropy


def init_params(cfg: CNNConfig, generator: torch.Generator, device: torch.device) -> Params:
    """Random init with the reference's scales (its own bits: drawn on the
    CPU ``generator``, then moved, so a CPU and a GPU run share them)."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    p: Params = {}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.conv_channels):
        p[f"conv{i}_w"] = normal(cout, cin, 3, 3) / math.sqrt(9 * cin)
        p[f"conv{i}_b"] = torch.zeros(cout)
        cin = cout
    spatial = cfg.image_size // 8  # three 2x2 max-pools
    dims = (spatial * spatial * cfg.conv_channels[-1],) + cfg.fc_dims + (cfg.num_classes,)
    for i in range(len(dims) - 1):
        p[f"fc{i}_w"] = normal(dims[i], dims[i + 1]) / math.sqrt(dims[i])
        p[f"fc{i}_b"] = torch.zeros(dims[i + 1])
    return {k: v.to(device) for k, v in p.items()}


def forward(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg.conv_channels)):
        # "SAME" for a 3x3 stride-1 kernel is one pixel of padding per side
        x = F.relu(F.conv2d(x, p[f"conv{i}_w"], p[f"conv{i}_b"], padding=1))
        if i % 2 == 1:  # pool after every second conv -> 3 pools
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    n_fc = len(cfg.fc_dims) + 1
    for i in range(n_fc):
        x = x @ p[f"fc{i}_w"] + p[f"fc{i}_b"]
        if i < n_fc - 1:
            x = F.relu(x)
    return x


def loss_fn(cfg: CNNConfig, p: Params, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return softmax_cross_entropy(forward(cfg, p, images), labels)


def feature_vector(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """Paper's proxy feature: mean softmax output over the batch (Eq. 5/6)."""
    return torch.softmax(forward(cfg, p, images).float(), dim=-1).mean(dim=0)


def feature_vectors(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """:func:`feature_vector` of ONE shared model for each of N clients'
    batches, as one forward over all N·b images: (N, b, H, W, C) -> (N, F)."""
    n, b = images.shape[:2]
    logits = forward(cfg, p, images.reshape((n * b,) + images.shape[2:])).float()
    return torch.softmax(logits, dim=-1).reshape(n, b, -1).mean(dim=1)


def predictions(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    return torch.argmax(forward(cfg, p, images), dim=-1)


def macro_f1(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Macro-averaged F1 (the paper's learning metric): per class c < num_classes
    2 tp / max(2 tp + fp + fn, 1), counted for all classes at once (an LM
    client's classes are its vocab), then the mean."""
    hit = preds == labels

    def count(x: torch.Tensor) -> torch.Tensor:
        x = x[(x >= 0) & (x < num_classes)]
        return torch.bincount(x, minlength=num_classes)

    tp, fp, fn = count(preds[hit]), count(preds[~hit]), count(labels[~hit])
    return (2 * tp / torch.clamp(2 * tp + fp + fn, min=1)).float().mean()
