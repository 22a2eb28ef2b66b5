"""Step functions of the training and serving entry points: the port of
``repro.launch.steps``.

train_step : one FL client's local SGD step on the LM objective (the
             paper's BATCHTRAIN at modern scale): ``decoder.loss_fn`` under
             autograd, on the plain forms (the kernels serve inference).
prefill    : full-sequence forward, last-position logits (serving prefill),
             with the scan through the ``ssd_scan`` kernel and
             self-attention through the ``swa_attention`` kernel by
             default; ``batch`` may hold ``prefix_embeddings`` (a VLM) and
             must hold ``encoder_frames`` for an encoder-decoder.
serve_step : single-token decode against the SSM and KV caches (and an
             encoder-decoder's cross K/V planes, or ``encoder_out``).

Prefill and serve steps run under ``torch.inference_mode()``, or
``torch.no_grad()`` on DTensor params (DTensor's ops do not take inference
tensors).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder, spmd
from repro_torch.optim import sgd_update


def _no_grad(params):
    """``inference_mode`` for plain params; ``no_grad`` for DTensors."""
    return torch.no_grad() if spmd.is_dtensor(params["embed"]) else torch.inference_mode()


def make_train_step(
    cfg: ModelConfig, lr: float = 0.01, remat: bool = True, ce_impl: str = "gather", ce_chunk: int = 0
):
    """``train_step(params, batch) -> (loss, new_params)``: the loss of
    ``decoder.loss_fn`` (``remat``, ``ce_impl`` and ``ce_chunk`` passed on),
    its gradient by ``torch.autograd.grad`` over every leaf of the param
    tree, then one SGD step of ``lr`` (the update rounded to each leaf's
    dtype).  ``torch.autograd`` and not ``torch.func``: the checkpoints of
    ``remat`` and of the chunked CE use saved-tensor hooks, which the
    function transforms do not take.  The loss comes back detached."""

    def train_step(params, batch: Dict[str, torch.Tensor]):
        flat = decoder.flat_params(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        with torch.enable_grad():
            loss, _ = decoder.loss_fn(
                cfg, decoder.nest_params(leaves), batch, remat=remat, ce_impl=ce_impl, ce_chunk=ce_chunk
            )
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = sgd_update(flat, dict(zip(leaves, grads)), lr)
        return loss.detach(), decoder.nest_params(new)

    return train_step


def make_prefill_step(cfg: ModelConfig, use_kernel: bool = True):
    def prefill(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with _no_grad(params):
            logits, _ = decoder.forward_logits(
                cfg,
                params,
                batch["tokens"],
                prefix_embeddings=batch.get("prefix_embeddings"),
                encoder_frames=batch.get("encoder_frames"),
                last_only=True,
                use_kernel=use_kernel,
            )
        return logits

    return prefill


def make_serve_step(cfg: ModelConfig, rolling: bool = False, with_encoder: bool = False):
    """``with_encoder`` (an encoder-decoder without cross K/V planes in its
    cache): the step also takes ``encoder_out`` and projects it per token."""
    if with_encoder:

        def serve_step(params, cache, tokens: torch.Tensor, positions: torch.Tensor, encoder_out: torch.Tensor):
            with _no_grad(params):
                return decoder.decode_step(
                    cfg, params, cache, tokens, positions, rolling=rolling, encoder_out=encoder_out
                )

    else:

        def serve_step(params, cache, tokens: torch.Tensor, positions: torch.Tensor):
            with _no_grad(params):
                return decoder.decode_step(cfg, params, cache, tokens, positions, rolling=rolling)

    return serve_step
