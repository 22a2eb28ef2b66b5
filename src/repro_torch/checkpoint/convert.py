"""Carry weights and simulator state across from the JAX package.

The reference stores conv kernels HWIO; the port stores them OIHW.  Every
other leaf keeps its layout (FC weights are (in, out) in both, and the
port's flatten before ``fc0`` is in the reference's (h, w, c) order).  All
inputs and outputs are numpy arrays, so neither side imports the other."""
from __future__ import annotations

from typing import Any, Dict, Mapping

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
