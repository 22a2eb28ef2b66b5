"""Carry weights and state across from the JAX package.

CNN: the reference stores conv kernels HWIO; the port stores them OIHW.
Every other leaf keeps its layout (FC weights are (in, out) in both, and the
port's flatten before ``fc0`` is in the reference's (h, w, c) order).

Decoder: the reference keeps ``blocks``, a tuple of ``cfg.block_period``
per-position dicts whose leaves are stacked over ``n_blocks``; layer
``b * period + j`` is entry ``b`` of position ``j``.  The port keeps one
dict per layer (an encoder-decoder's ``enc_blocks`` likewise become
``enc_layers``).  Leaves keep their layout (dense weights (in, out)); bf16
leaves arrive as ``ml_dtypes.bfloat16`` or as a uint16 view and leave as a
uint16 view, bit for bit.  All inputs and outputs are numpy arrays, so
neither side imports the other."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_conv_w(name: str) -> bool:
    return name.startswith("conv") and name.endswith("_w")


def params_from_reference(
    np_params: Mapping[str, Any], device: str | torch.device | None = None, stacked: bool = False
) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, HWIO convs) -> port params (OIHW convs).
    ``stacked`` params carry a leading client axis."""
    device = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if _is_conv_w(name):
            t = t.permute((0, 4, 3, 1, 2) if stacked else (3, 2, 0, 1))
        out[name] = t.contiguous().to(device)
    return out


def params_to_reference(params: Mapping[str, torch.Tensor], stacked: bool = False) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_reference`: numpy arrays in the JAX layout."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if _is_conv_w(name):
            t = t.permute((0, 3, 4, 2, 1) if stacked else (2, 3, 1, 0))
        out[name] = t.contiguous().numpy()
    return out


def carry_from_reference(fields: Mapping[str, Any], device: str | torch.device | None = None):
    """A port ``EpochCarry`` from the reference ``EpochCarry``'s fields as
    numpy arrays (``global_params``, ``msg_params``, ``h``, ``age``,
    ``battery``, ``pending``, ``counter``; ``retries``/``backoff`` default to
    zero).  The reference's PRNG key has no counterpart: the port takes its
    draws from a ``core.draws`` source."""
    from repro_torch.core.simulator import EpochCarry

    device = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.asarray(fields[name]), dtype=dtype, device=device)

    n = np.asarray(fields["age"]).shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    return EpochCarry(
        global_params=params_from_reference(fields["global_params"], device),
        msg_params=params_from_reference(fields["msg_params"], device, stacked=True),
        h=t("h", torch.float32),
        age=t("age", torch.float32),
        battery=t("battery", torch.int32),
        pending=t("pending", torch.bool),
        counter=t("counter", torch.int32),
        retries=t("retries", torch.int32) if "retries" in fields else zeros,
        backoff=t("backoff", torch.int32) if "backoff" in fields else zeros.clone(),
    )


# ---------------------------------------------------------------------------
# Decoder params and decode caches
# ---------------------------------------------------------------------------


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor with the same bits: ``ml_dtypes.bfloat16``
    and uint16 views become ``torch.bfloat16`` (``torch.from_numpy`` takes
    neither), through an int16 view."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy`: bf16 leaves as a uint16 view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: Sequence[Any]) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _unstack_blocks(positions: Sequence[Any], num_layers: int, device) -> List[Any]:
    """Reference per-position trees stacked over blocks -> one tree per layer."""
    period = len(positions)
    n_blocks = num_layers // period
    layers: List[Any] = [None] * num_layers
    for j, pos in enumerate(positions):
        for b in range(n_blocks):
            layers[b * period + j] = _map(lambda a, b=b: tensor_from_numpy(np.asarray(a)[b], device), pos)
    return layers


def _stack_blocks(layers: Sequence[Any], period: int) -> tuple:
    """Inverse of :func:`_unstack_blocks`."""
    n_blocks = len(layers) // period
    return tuple(
        _stack([_map(tensor_to_numpy, layers[b * period + j]) for b in range(n_blocks)]) for j in range(period)
    )


_DECODER_KEYS = {
    "embed", "final_norm", "blocks", "lm_head", "pos_embed", "enc_blocks", "enc_pos_embed", "enc_final_norm"
}
# leaves and subtrees outside the layer stacks, carried as they are
_PLAIN_KEYS = ("embed", "final_norm", "lm_head", "pos_embed", "enc_pos_embed", "enc_final_norm")


def _check_period(positions: Sequence[Any], cfg, what: str) -> None:
    if len(positions) != cfg.block_period:
        raise ValueError(f"{len(positions)} {what} positions, but {cfg.name} has period {cfg.block_period}")


def decoder_params_from_reference(np_params: Mapping[str, Any], cfg, device: str | torch.device | None = None):
    """Reference decoder params (numpy leaves) -> the port's
    ``models.decoder`` params: ``blocks`` become ``layers`` and an
    encoder-decoder's ``enc_blocks`` become ``enc_layers``, one dict per
    layer (MoE layers' fp32 ``router`` stays fp32 in a bf16 tree)."""
    from repro_torch.models.decoder import encoder_config

    extra = set(np_params) - _DECODER_KEYS
    if extra:
        raise ValueError(f"params {sorted(extra)} are not decoder params")
    device = resolve_device(device)
    _check_period(np_params["blocks"], cfg, "block")
    out = {k: _map(lambda a: tensor_from_numpy(a, device), np_params[k]) for k in _PLAIN_KEYS if k in np_params}
    out["layers"] = _unstack_blocks(np_params["blocks"], cfg.num_layers, device)
    if "enc_blocks" in np_params:
        enc = encoder_config(cfg)
        _check_period(np_params["enc_blocks"], enc, "encoder block")
        out["enc_layers"] = _unstack_blocks(np_params["enc_blocks"], enc.num_layers, device)
    return out


def decoder_params_to_reference(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """Inverse of :func:`decoder_params_from_reference`: numpy leaves in the
    reference's layout, bf16 as a uint16 view."""
    from repro_torch.models.decoder import encoder_config

    out = {k: _map(tensor_to_numpy, params[k]) for k in _PLAIN_KEYS if k in params}
    out["blocks"] = _stack_blocks(params["layers"], cfg.block_period)
    if "enc_layers" in params:
        out["enc_blocks"] = _stack_blocks(params["enc_layers"], encoder_config(cfg).block_period)
    return out


def decoder_cache_from_reference(np_cache: Sequence[Any], cfg, device: str | torch.device | None = None):
    """Reference decode cache (a tuple of per-position dicts stacked over
    blocks: ``k``/``v`` (B, W, Hkv, hd) for attention layers, ``conv`` in the
    model dtype and ``ssm`` fp32 for SSM layers, and an encoder-decoder's
    cross-attention planes ``ck``/``cv`` (B, S_enc, Hkv, hd)) -> one dict
    per layer."""
    return _unstack_blocks(np_cache, cfg.num_layers, resolve_device(device))


def decoder_cache_to_reference(cache: Sequence[Any], cfg) -> tuple:
    """Inverse of :func:`decoder_cache_from_reference`."""
    return _stack_blocks(cache, cfg.block_period)
