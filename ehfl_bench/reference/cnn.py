"""The paper's §V CNN in plain PyTorch, for the reference: six 3x3 convs
("same" padding) with a 2x2 max-pool after every second, three dense
layers, softmax output.  Parameters are a dict ``conv{i}_w`` (OIHW),
``conv{i}_b``, ``fc{i}_w`` (in, out), ``fc{i}_b``; images are NHWC and the
flatten before the first dense layer is in (h, w, c) order.

``rounding`` is the control's lower precision: every operand of a
convolution or matrix product, forward and backward, rounded to TF32 (10
mantissa bits) with fp32 accumulation.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to the nearest TF32 value (ties to even), kept as fp32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: the incoming gradient
    rounded too, since it is the operand of the backward's products."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class _Output(torch.autograd.Function):
    """Forward: unchanged; backward: the gradient reaching a product's output
    rounded, as it enters that product's backward."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class CNN:
    def __init__(self, model: Dict, rounding: bool = False):
        self.n_conv = len(model["conv_channels"])
        self.n_fc = len(model["fc_dims"]) + 1
        self.num_classes = model["num_classes"]
        self.rounding = rounding

    def _op(self, x):
        return _Operand.apply(x) if self.rounding else x

    def _out(self, x):
        return _Output.apply(x) if self.rounding else x

    def forward(self, p: Params, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            x = self._out(F.conv2d(self._op(x), self._op(p[f"conv{i}_w"]), p[f"conv{i}_b"], padding=1))
            x = torch.relu(x)
            if i % 2 == 1:
                x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(self.n_fc):
            x = self._out(self._op(x) @ self._op(p[f"fc{i}_w"])) + p[f"fc{i}_b"]
            if i < self.n_fc - 1:
                x = torch.relu(x)
        return x

    def loss(self, p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self.forward(p, x).float(), y)

    def feature(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Mean softmax output over the batch (the paper's proxy, Eq. 5/6)."""
        return torch.softmax(self.forward(p, x).float(), dim=-1).mean(dim=0)

    def probe(self, p: Params, images: torch.Tensor, block: int = 2048) -> torch.Tensor:
        """(n, b, ...) -> (n, F): :meth:`feature` of each client's batch,
        ``block`` images a forward."""
        n, b = images.shape[:2]
        flat = images.reshape((n * b,) + images.shape[2:])
        probs = torch.cat([torch.softmax(self.forward(p, flat[i : i + block]).float(), dim=-1)
                           for i in range(0, n * b, block)])
        return probs.reshape(n, b, -1).mean(dim=1)
