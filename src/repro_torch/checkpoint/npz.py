"""Reader and writer of ``repro.checkpoint.npz``'s format.

Leaves of a nested dict (or list/tuple) tree are stored under '/'-joined key
paths in one ``.npz``; a ``__meta__`` JSON entry marks the keys whose leaves
are bf16, which are stored as a uint16 view.  Files written by either package
load in the other."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = tree
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)


def save_pytree(tree: Any, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves: Dict[str, Any] = {}
    _flatten(tree, "", leaves)
    flat: Dict[str, np.ndarray] = {}
    meta: Dict[str, str] = {}
    for key, leaf in leaves.items():
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            meta[key] = "bfloat16"
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_arrays(path: str | Path, device: str | torch.device = "cpu") -> Dict[str, torch.Tensor]:
    """Every leaf of a checkpoint as ``{'/'-joined key: tensor}``."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        out = {}
        for key in data.files:
            if key == "__meta__":
                continue
            arr = data[key]
            if meta.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.copy())
            out[key] = t.to(device)
    return out


def load_pytree(template: Any, path: str | Path) -> Any:
    """Restore ``template``'s structure, dtypes, shapes and devices from ``path``."""
    arrays = load_arrays(path)

    def restore(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: restore(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(restore(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree))
        return arrays[prefix].to(dtype=tree.dtype, device=tree.device).reshape(tree.shape)

    return restore(template, "")
