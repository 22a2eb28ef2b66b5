"""Backends binding models to the EHFL simulator.

Contract: ``grad_loss``/``feature``/``predict`` are pure per-client functions
of (params, batch): the simulator batches them over clients with
``torch.func.vmap``, so they may hold no hidden state.  ``probe`` is the one
batched function: one shared model over N clients' probe batches.
"""
from __future__ import annotations

from torch.func import grad_and_value

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core.simulator import Backend
from repro_torch.models import cnn


def cnn_backend(cfg: CNNConfig) -> Backend:
    gv = grad_and_value(lambda p, x, y: cnn.loss_fn(cfg, p, x, y))

    def grad_loss(p, x, y):
        grads, loss = gv(p, x, y)
        return loss, grads

    return Backend(
        init=lambda generator, device: cnn.init_params(cfg, generator, device),
        grad_loss=grad_loss,
        feature=lambda p, x: cnn.feature_vector(cfg, p, x),
        probe=lambda p, x: cnn.feature_vectors(cfg, p, x),
        predict=lambda p, x: cnn.predictions(cfg, p, x),
        feature_dim=cfg.num_classes,
        num_classes=cfg.num_classes,
    )
