"""Faults planted under the timed path, for the tests and the control runs:
each must turn ``correct`` false.  A fault is a pair (on the backend, on
the epoch function), either part ``None``, that ``run.plant`` lays under
the port's epoch function after the fleet has settled, so the check
epochs and the window run with it.

- ``unchanged``: an epoch that returns its carry unchanged;
- ``half_batch``: local SGD's gradient over half of each minibatch, the
  mean taken over the rest;
- ``altered_message``: one weight of each message a client trains
  altered where the slab writes it back;
- ``altered_global``: one weight of each new global model altered where
  FedAvg produces it;
- ``stale_moment`` (VAoI cells): the Eq. 6 moments written back
  unchanged, so a client that trained keeps its old moment.

The cells run on one chip, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def unchanged(epoch_fn):
    def fn(carry, t, draws):
        _, metrics = epoch_fn(carry, t, draws)
        return carry, metrics

    return fn


def half_batch(backend):
    grad_loss = backend.grad_loss
    return backend._replace(grad_loss=lambda p, x, y: grad_loss(p, x[: len(x) // 2], y[: len(y) // 2]))


def _nudged(leaf):
    """``leaf`` with its first element moved by a hundredth of its largest."""
    leaf = leaf.clone()
    leaf.view(-1)[0] += 1e-2 * (leaf.abs().max() + 1)
    return leaf


def altered_message(epoch_fn):
    def fn(carry, t, draws):
        out, metrics = epoch_fn(carry, t, draws)
        first = sorted(out.msg_params)[0]
        new, old = out.msg_params[first], carry.msg_params[first]
        trained = (new != old).reshape(new.shape[0], -1).any(dim=1)
        leaf = new.clone()
        for i in torch.nonzero(trained).flatten().tolist():
            leaf[i] = _nudged(new[i])
        return out._replace(msg_params={**out.msg_params, first: leaf}), metrics

    return fn


def altered_global(epoch_fn):
    def fn(carry, t, draws):
        carry, metrics = epoch_fn(carry, t, draws)
        params = dict(carry.global_params)
        first = sorted(params)[0]
        params[first] = _nudged(params[first])
        return carry._replace(global_params=params), metrics

    return fn


def stale_moment(epoch_fn):
    def fn(carry, t, draws):
        out, metrics = epoch_fn(carry, t, draws)
        return out._replace(h=carry.h), metrics

    return fn


FAULTS: Dict[str, Tuple[Callable | None, Callable | None]] = {
    "unchanged": (None, unchanged), "half_batch": (half_batch, None),
    "altered_message": (None, altered_message), "altered_global": (None, altered_global),
    "stale_moment": (None, stale_moment)}
