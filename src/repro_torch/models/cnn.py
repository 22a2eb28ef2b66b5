"""The paper's client model (§V): 6 conv layers, 3 max-pools, 3 FC layers.

Functional PyTorch on a dict of tensors keyed like ``repro.models.cnn``'s
params (``conv{i}_w``, ``conv{i}_b``, ``fc{i}_w``, ``fc{i}_b``).  Conv weights
are stored OIHW (PyTorch's layout; ``checkpoint/convert.py`` maps the
reference's HWIO), FC weights (in, out) as in the reference.  Images stay NHWC
at every public function and are permuted once inside :func:`forward`, which
permutes back to NHWC before the flatten so ``fc0_w``'s rows keep the
reference's (h, w, c) order.  ``feature_vector`` taps the output layer
(10 logits -> softmax), the paper's VAoI proxy.

:func:`grad_loss` and :func:`feature` are one client's gradient and Eq. 6
feature, for the simulator to vmap over its clients.  Each is an
``autograd.Function`` whose ``vmap`` rule sees whether the weights carry
the batch dim: lanes that each hold their own client's weights, on CUDA,
run the lanes' forward (and backward) at once (:func:`lane_grad_loss`,
:func:`lane_feature`), every convolution one ``kernels.conv_lanes`` launch
a direction for all lanes.  Elsewhere (the CPU, shared weights) each rule
runs the vmap of the per-client function, so those results keep their
bits.  One rule a call keeps functorch's Python to one pass a SGD step;
the probe's one shared model and the eval stay on ``F.conv2d``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad_and_value

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import Params, softmax_cross_entropy, softmax_cross_entropy_per_token


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


def _logits(cfg: CNNConfig, p: Params, images: torch.Tensor, conv) -> torch.Tensor:
    """The architecture, written once: images (..., B, H, W, C) -> logits
    (..., B, num_classes), where ``...`` is nothing for one client and (L,)
    for L lanes with their own weights (p {name: (L, ...)}).  ``conv(x, w,
    b)`` is each 3x3 "SAME" convolution of x (..., B, C, H, W)."""
    x = images.movedim(-1, -3)
    for i in range(len(cfg.conv_channels)):
        x = F.relu(conv(x, p[f"conv{i}_w"], p[f"conv{i}_b"]))
        if i % 2 == 1:  # pool after every second conv -> 3 pools
            x = F.max_pool2d(x.flatten(0, -4), 2).unflatten(0, x.shape[:-3])
    x = x.movedim(-3, -1).flatten(-3)
    n_fc = len(cfg.fc_dims) + 1
    for i in range(n_fc):
        x = x @ p[f"fc{i}_w"] + p[f"fc{i}_b"].unsqueeze(-2)
        if i < n_fc - 1:
            x = F.relu(x)
    return x


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # "SAME" for a 3x3 stride-1 kernel is one pixel of padding per side
    return F.conv2d(x, w, b, padding=1)


def forward(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    return _logits(cfg, p, images, _conv2d)


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


# --- one client as the simulator vmaps it; lanes where each holds its own ---


def client_grad_loss(cfg: CNNConfig, p: Params, images: torch.Tensor,
                     labels: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One client's (loss, dL/dp) by ``torch.func``."""
    grads, loss = grad_and_value(lambda p, x, y: loss_fn(cfg, p, x, y))(p, images, labels)
    return loss, grads


class _LaneConv(torch.autograd.Function):
    """The "SAME" 3x3 convolution of lanes that each hold their own weights:
    x (L, B, Cin, H, W), w (L, Cout, Cin, 3, 3), b (L, Cout) -> (L, B, Cout,
    H, W) through ``kernels.ops.conv_lanes`` (one launch a direction on
    CUDA, the plain versions on the CPU); dL/dx only where x needs it."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return kops.conv_lanes(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = kops.conv_lanes_input_grad(g, x, w) if ctx.needs_input_grad[0] else None
        gw, gb = kops.conv_lanes_weight_grad(g, x, w)
        return gx, gw, gb


def lane_logits(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """:func:`forward` of L clients at once: p {name: (L, ...)}, images
    (L, B, H, W, C) -> logits (L, B, num_classes); the convolutions through
    :class:`_LaneConv`."""
    return _logits(cfg, p, images, _LaneConv.apply)


def lane_grad_loss(cfg: CNNConfig, p: Params, images: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """:func:`client_grad_loss` of L clients at once -> (losses (L,), grads
    {name: (L, ...)}): one backward of the lanes' summed losses, each lane's
    weights reaching only its own loss."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        losses = softmax_cross_entropy_per_token(lane_logits(cfg, leaves, images), labels).mean(dim=1)
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    return losses.detach(), dict(zip(leaves, grads))


def lane_feature(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """:func:`feature_vector` of L clients at once -> (L, num_classes)."""
    with torch.no_grad():
        return torch.softmax(lane_logits(cfg, p, images).float(), dim=-1).mean(dim=1)


def _as_lanes(n: int, in_dims, tensors):
    """The tensors with their batch dim first, expanded to ``n`` where unbatched."""
    return [t.expand(n, *t.shape) if d is None else t.movedim(d, 0) for t, d in zip(tensors, in_dims)]


def _on_lanes(in_dims, leaves) -> bool:
    """Whether a vmap rule runs the lanes: every weight batched, on CUDA."""
    return all(d is not None for d in in_dims) and leaves[0].is_cuda


class _GradLoss(torch.autograd.Function):
    """(loss, *dL/dp in ``keys`` order) of one client, from (images, labels,
    *p in ``keys`` order)."""

    @staticmethod
    def forward(cfg, keys, images, labels, *leaves):
        loss, grads = client_grad_loss(cfg, dict(zip(keys, leaves)), images, labels)
        return (loss, *(grads[k] for k in keys))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("grad_loss has no derivative")

    @staticmethod
    def vmap(info, in_dims, cfg, keys, images, labels, *leaves):
        out_dims = (0,) * (1 + len(keys))
        if not _on_lanes(in_dims[4:], leaves):
            run = functools.partial(_GradLoss.forward, cfg, keys)
            return torch.vmap(run, in_dims=in_dims[2:])(images, labels, *leaves), out_dims
        images, labels, *leaves = _as_lanes(info.batch_size, in_dims[2:], (images, labels, *leaves))
        losses, grads = lane_grad_loss(cfg, dict(zip(keys, leaves)), images, labels)
        return (losses, *(grads[k] for k in keys)), out_dims


class _Feature(torch.autograd.Function):
    """:func:`feature_vector` of one client, from (images, *p in ``keys`` order)."""

    @staticmethod
    def forward(cfg, keys, images, *leaves):
        return feature_vector(cfg, dict(zip(keys, leaves)), images)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the feature tap has no derivative")

    @staticmethod
    def vmap(info, in_dims, cfg, keys, images, *leaves):
        if not _on_lanes(in_dims[3:], leaves):
            run = functools.partial(_Feature.forward, cfg, keys)
            return torch.vmap(run, in_dims=in_dims[2:])(images, *leaves), 0
        images, *leaves = _as_lanes(info.batch_size, in_dims[2:], (images, *leaves))
        return lane_feature(cfg, dict(zip(keys, leaves)), images), 0


def grad_loss(cfg: CNNConfig, p: Params, images: torch.Tensor,
              labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One client's (loss, dL/dp); vmapped over clients that each hold their
    own weights on CUDA, all of them at once through the lane kernel."""
    keys = tuple(p)
    loss, *grads = _GradLoss.apply(cfg, keys, images, labels, *(p[k] for k in keys))
    return loss, dict(zip(keys, grads))


def feature(cfg: CNNConfig, p: Params, images: torch.Tensor) -> torch.Tensor:
    """One client's :func:`feature_vector`; vmapped like :func:`grad_loss`."""
    keys = tuple(p)
    return _Feature.apply(cfg, keys, images, *(p[k] for k in keys))
