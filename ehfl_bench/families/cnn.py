"""The ``cnn`` family: the paper's §V client model on CIFAR-shaped data.

Inputs made on the device from the seed, in a few large calls: the client
pools and test set (the port's synthetic recipe: smooth class prototypes
plus Gaussian noise, Dirichlet(alpha) labels per client) and the initial
weights (the port's init scales: N(0, 1/fan_in), zero biases).  The
program's side is ``repro_torch.fl.backend.cnn_backend``; the reference's
``reference/cnn.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ehfl_bench.world import seed_words


def leaf_shapes(model: Dict[str, Any]) -> Dict[str, tuple]:
    shapes, cin = {}, model["in_channels"]
    for i, cout in enumerate(model["conv_channels"]):
        shapes[f"conv{i}_w"], shapes[f"conv{i}_b"] = (cout, cin, 3, 3), (cout,)
        cin = cout
    spatial = model["image_size"] // 8
    dims = [spatial * spatial * model["conv_channels"][-1], *model["fc_dims"], model["num_classes"]]
    for i in range(len(dims) - 1):
        shapes[f"fc{i}_w"], shapes[f"fc{i}_b"] = (dims[i], dims[i + 1]), (dims[i + 1],)
    return shapes


def init_params(model: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """All weights from one normal draw on the device, split and scaled by
    1/sqrt(fan_in); biases zero.  fp32, as the configuration states."""
    shapes = leaf_shapes(model)
    weights = {k: s for k, s in shapes.items() if k.endswith("_w")}
    g = torch.Generator(device=device).manual_seed(seed_words(seed, 1))
    flat = torch.randn(sum(math.prod(s) for s in weights.values()), generator=g, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        if k in weights:
            fan_in = math.prod(s[1:]) if k.startswith("conv") else s[0]
            out[k] = flat[off : off + math.prod(s)].view(s) / math.sqrt(fan_in)
            off += math.prod(s)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def make_data(model: Dict[str, Any], ehfl: Dict[str, Any], n_clients: int, seed: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Client pools (N, n, H, W, C) fp32 with labels (N, n) int64 and a
    balanced test set, on ``device``."""
    c, size, ch = model["num_classes"], model["image_size"], model["in_channels"]
    n, noise = ehfl["samples_per_client"], ehfl["noise"]
    g = torch.Generator(device=device).manual_seed(seed_words(seed, 0))
    coarse = torch.randn(c, ch, 8, 8, generator=g, device=device) * 1.5
    protos = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    props = np.random.default_rng(seed_words(seed, 4)).dirichlet(np.full(c, ehfl["alpha"]), size=n_clients)
    labels = torch.multinomial(torch.as_tensor(props, device=device), n, replacement=True, generator=g)
    images = torch.randn(n_clients, n, size, size, ch, generator=g, device=device).mul_(noise)
    for i in range(0, n_clients, 100):  # add the prototypes a block of clients at a time
        images[i : i + 100] += protos[labels[i : i + 100]]
    test_labels = torch.arange(ehfl["test_size"], device=device) % c
    test_images = torch.randn(ehfl["test_size"], size, size, ch, generator=g, device=device).mul_(noise)
    test_images += protos[test_labels]
    return {"images": images, "labels": labels, "test_images": test_images, "test_labels": test_labels}


def backend(model: Dict[str, Any]):
    from repro_torch.configs.cifar_cnn import CNNConfig
    from repro_torch.fl.backend import cnn_backend

    return cnn_backend(CNNConfig(name="paper-cnn", image_size=model["image_size"], in_channels=model["in_channels"],
                                 num_classes=model["num_classes"], conv_channels=tuple(model["conv_channels"]),
                                 fc_dims=tuple(model["fc_dims"])))


def reference(model: Dict[str, Any], rounding: bool = False):
    from ehfl_bench.reference.cnn import CNN

    return CNN(model, rounding=rounding)


def param_count(model: Dict[str, Any]) -> int:
    return sum(math.prod(s) for s in leaf_shapes(model).values())


def forward_flops(model: Dict[str, Any]) -> int:
    """FLOPs of one image's forward: 2 per multiply-add of each conv and
    dense layer (bias adds, ReLUs and pools not counted)."""
    size, cin, flops = model["image_size"], model["in_channels"], 0
    for i, cout in enumerate(model["conv_channels"]):
        flops += 2 * size * size * cout * cin * 9
        cin = cout
        if i % 2 == 1:
            size //= 2
    dims = [size * size * cin, *model["fc_dims"], model["num_classes"]]
    return flops + sum(2 * a * b for a, b in zip(dims, dims[1:]))


def useful_flops(cell: Dict[str, Any], cfg, n_epochs: int, n_started: int, n_evals: int) -> float:
    """The useful FLOPs of ``n_epochs`` epochs that started ``n_started``
    clients in all, with ``n_evals`` evaluations: the probe over N x
    probe_size images an epoch (VAoI policies), 3 forwards' worth a trained
    sample (forward and backward) and one more for the feature tap (VAoI
    policies), the eval forward over the test set.  Padding lanes of the
    slab and the dense path's lanes that did not start are not counted."""
    model, ehfl = cell["model_config"]["model"], cell["model_config"]["ehfl"]
    fwd = forward_flops(model)
    vaoi = cfg.policy == "vaoi"
    bs = max(1, ehfl["samples_per_client"] // cfg.kappa)
    per_client = cfg.kappa * bs * fwd * (4 if vaoi else 3)
    probe = cfg.num_clients * cfg.probe_size * fwd if vaoi else 0
    return float(n_started * per_client + n_epochs * probe + n_evals * ehfl["test_size"] * fwd)


def leaf_bytes(model: Dict[str, Any]) -> Dict[str, int]:
    """Columns and element size of each leaf dtype group the FedAvg kernel
    reduces: one fp32 group."""
    return {"float32": (param_count(model), 4)}


def feature_dim(model: Dict[str, Any]) -> int:
    return model["num_classes"]


def feature_bytes() -> int:
    """Bytes of an element of the probe's features (fp32 softmax means)."""
    return 4
