"""Synthetic data pipeline: ``repro.data.synthetic``'s protocol, its own bits.

A class-conditional Gaussian image dataset with CIFAR-10's geometry
(32x32x3, 10 classes), partitioned across clients with a Dirichlet(alpha)
label distribution: the paper's non-IID protocol (§V).  Everything is drawn
on the CPU from ``seed`` (a ``torch.Generator``, plus numpy's generator for
the Dirichlet proportions, which ``torch.Generator`` cannot sample) and moved
to ``device`` in one copy, so a CPU and a GPU run see the same data.
``make_token_dataset`` is the LM clients' counterpart: Dirichlet mixtures
of vocab topics, for at-scale FL training (``launch/train.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def make_class_prototypes(
    generator: torch.Generator, num_classes: int, image_size: int, channels: int
) -> torch.Tensor:
    """Smooth per-class prototype images (C, H, W, ch): low-frequency
    patterns, so a CNN can learn them."""
    coarse = torch.randn(num_classes, channels, 8, 8, generator=generator) * 1.5
    protos = F.interpolate(coarse, size=(image_size, image_size), mode="bilinear", align_corners=False)
    return protos.permute(0, 2, 3, 1).contiguous()


def dirichlet_label_partition(
    seed: int, generator: torch.Generator, num_clients: int, samples_per_client: int,
    num_classes: int, alpha: float,
) -> torch.Tensor:
    """Per-client label arrays (N, n) sampled from client-specific Dir(alpha) mixtures."""
    props = np.random.default_rng(seed).dirichlet(np.full(num_classes, alpha), size=num_clients)
    return torch.multinomial(
        torch.as_tensor(props, dtype=torch.float64), samples_per_client,
        replacement=True, generator=generator,
    )


def make_federated_dataset(
    seed: int = 0,
    num_clients: int = 100,
    samples_per_client: int = 300,
    num_classes: int = 10,
    image_size: int = 32,
    channels: int = 3,
    alpha: float = 0.1,
    test_size: int = 1000,
    noise: float = 0.8,
    device: str | torch.device | None = None,
) -> Dict[str, torch.Tensor]:
    """Returns dict with client images (N, n, H, W, C), labels (N, n) int64,
    plus a balanced global test set."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    protos = make_class_prototypes(g, num_classes, image_size, channels)
    labels = dirichlet_label_partition(seed, g, num_clients, samples_per_client, num_classes, alpha)
    eps = torch.randn(num_clients, samples_per_client, image_size, image_size, channels, generator=g)
    images = protos[labels] + noise * eps
    test_labels = torch.arange(test_size) % num_classes
    test_eps = torch.randn(test_size, image_size, image_size, channels, generator=g)
    test_images = protos[test_labels] + noise * test_eps
    out = {"images": images, "labels": labels, "test_images": test_images, "test_labels": test_labels}
    return {k: v.to(device) for k, v in out.items()}


def make_token_dataset(
    generator: torch.Generator,
    num_clients: int,
    samples_per_client: int,
    seq_len: int,
    vocab_size: int,
    alpha: float = 0.5,
    num_topics: int = 16,
) -> Dict[str, torch.Tensor]:
    """Synthetic non-IID LM data, the reference's recipe: each token of the
    vocab belongs to one of ``num_topics`` topics, each client mixes the
    topics with Dirichlet(alpha) weights, and its sequences are drawn token
    by token from the resulting distribution over the vocab.  Returns
    ``{"tokens": (N, n, S) int32}`` on ``generator``'s device.  The
    Dirichlet weights come from numpy's generator, seeded from
    ``generator`` (``torch.Generator`` samples no Dirichlet)."""
    topic_of_token = torch.randint(0, num_topics, (vocab_size,), generator=generator, device=generator.device)
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    client_topic = np.random.default_rng(seed).dirichlet(np.full(num_topics, alpha), size=num_clients)
    token_probs = torch.as_tensor(client_topic, device=generator.device)[:, topic_of_token]  # (N, V) float64
    token_probs = token_probs / token_probs.sum(dim=-1, keepdim=True)
    tokens = torch.multinomial(token_probs, samples_per_client * seq_len, replacement=True, generator=generator)
    return {"tokens": tokens.reshape(num_clients, samples_per_client, seq_len).to(torch.int32)}
