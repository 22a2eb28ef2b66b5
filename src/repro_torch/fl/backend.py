"""Backends binding models to the EHFL simulator.

Contract: ``grad_loss``/``feature``/``predict`` are pure per-client functions
of (params, batch): the simulator batches them over clients with
``torch.func.vmap``, so they may hold no hidden state.  ``probe`` is the one
batched function: one shared model over N clients' probe batches.  Params
are a flat ``{name: tensor}`` dict, which the simulator stacks per client.
The CNN's ``grad_loss`` and ``feature`` stay such per-client functions, and
see that vmap: where it batches the weights (each lane its own client) and
the tensors are on CUDA, the lanes run at once, each convolution one
``kernels.conv_lanes`` launch a direction for all lanes; the probe's and the
eval's shared model, and the CPU, keep ``F.conv2d`` (``models/cnn.py``).
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core.simulator import Backend
from repro_torch.models import cnn


def cnn_backend(cfg: CNNConfig) -> Backend:
    return Backend(
        init=lambda generator, device: cnn.init_params(cfg, generator, device),
        grad_loss=lambda p, x, y: cnn.grad_loss(cfg, p, x, y),
        feature=lambda p, x: cnn.feature(cfg, p, x),
        probe=lambda p, x: cnn.feature_vectors(cfg, p, x),
        predict=lambda p, x: cnn.predictions(cfg, p, x),
        feature_dim=cfg.num_classes,
        num_classes=cfg.num_classes,
    )


def lm_backend(model_cfg: ModelConfig) -> Backend:
    """LM-as-client backend: tokens in, next-token loss, output-distribution
    feature tap (the paper's proxy at modern scale).  'images' are token
    sequences (N, n, S), which the simulator holds as float32 (exact below
    2^24) and which are read back as int64; 'labels' are unused (the LM loss
    is self-supervised).  The params are the decoder's, flat under dotted
    names (``models.decoder.flat_params``), nested again inside each
    function.  ``probe`` runs the shared model over all N probe batches in
    one forward, its attention through the ``swa_attention`` kernel (scan
    through ``ssd_scan``) on the card; ``grad_loss`` and ``feature`` run the
    plain forms, which ``torch.func.vmap`` batches over the clients (a
    routed stack too: ``models/moe.py``'s dispatch has fixed shapes).
    Latent attention (MLA) takes its ``mla_attention`` kernel in every
    pass on CUDA bf16, its vmap rules folding the clients into one launch.

    Takes every decoder-only arch; raises ``ValueError`` for an
    encoder-decoder, whose forward needs encoder frames that the
    simulator's batches do not carry (the reference's ``lm_backend``
    cannot run it either)."""
    from repro_torch.models import decoder

    if model_cfg.is_encoder_decoder:
        raise ValueError(f"{model_cfg.name} is an encoder-decoder: its forward needs encoder frames")

    def loss(p, toks, _labels):
        toks = toks.long()
        l, _ = decoder.loss_fn(model_cfg, decoder.nest_params(p), {"tokens": toks, "labels": toks},
                               aux_weight=model_cfg.aux_weight)
        return l

    gv = grad_and_value(loss)

    def grad_loss(p, toks, labels):
        grads, l = gv(p, toks, labels)
        return l, grads

    def init(generator: torch.Generator, device: torch.device):
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        return decoder.flat_params(decoder.init_params(model_cfg, seed, device))

    def predict(p, toks):
        logits, _ = decoder.forward_logits(model_cfg, decoder.nest_params(p), toks.long())
        return torch.argmax(logits[:, -1], dim=-1)

    return Backend(
        init=init,
        grad_loss=grad_loss,
        feature=lambda p, toks: decoder.feature_vector(model_cfg, decoder.nest_params(p), toks.long()),
        probe=lambda p, toks: decoder.feature_vectors(model_cfg, decoder.nest_params(p), toks.long(), use_kernel=True),
        predict=predict,
        feature_dim=model_cfg.vocab_size,
        num_classes=model_cfg.vocab_size,
    )
