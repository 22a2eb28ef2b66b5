"""Serving step functions: the port of ``repro.launch.steps``'s prefill
and serve steps.

prefill    : full-sequence forward, last-position logits (serving prefill),
             with the scan through the ``ssd_scan`` kernel and
             self-attention through the ``swa_attention`` kernel by
             default; ``batch`` may hold ``prefix_embeddings`` (a VLM) and
             must hold ``encoder_frames`` for an encoder-decoder.
serve_step : single-token decode against the SSM and KV caches (and an
             encoder-decoder's cross K/V planes, or ``encoder_out``).

Both run under ``torch.inference_mode()``.  The train step waits for the
training slice (ROADMAP queue 1 #12).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder


def make_prefill_step(cfg: ModelConfig, use_kernel: bool = True):
    def prefill(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
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
            with torch.inference_mode():
                return decoder.decode_step(
                    cfg, params, cache, tokens, positions, rolling=rolling, encoder_out=encoder_out
                )

    else:

        def serve_step(params, cache, tokens: torch.Tensor, positions: torch.Tensor):
            with torch.inference_mode():
                return decoder.decode_step(cfg, params, cache, tokens, positions, rolling=rolling)

    return serve_step
