"""The ``lm`` family: a decoder LM as the EHFL client, on synthetic token
clients, at one chip's share of each layer.

The configuration's ``model`` section names the port's registered arch
(``arch``) and carries the model as run, under the released config.json's
names: the widths, the layers held (``num_hidden_layers``), the experts
held of the router's ``n_routed_experts`` (``experts_held`` from
``expert_offset``), the vocabulary slice (``vocab_size``) and the sequence
length.  Inputs made on the device from the seed, in a few large calls:

- the clients' sequences by the port's synthetic token recipe
  (``data/synthetic.py::make_token_dataset``, frozen here): each token of
  the vocabulary belongs to one of ``topics`` topics, each client mixes the
  topics with Dirichlet(alpha) weights and draws its tokens from the mix;
  held as float32 ids (N, n, S) in ``images``, as ``lm_backend`` reads
  them, ``labels`` zeros (the loss is self-supervised); a test set of one
  sequence a client, its label the next token drawn from the same mix;
- the weights: one normal draw a leaf in fp32 on the device, scaled as the
  port initialises (dense N(0, 1/fan_in), embedding and head N(0, 0.02²),
  norms one), cast to the model dtype, the routers kept fp32.

The program's side is ``repro_torch.fl.backend.lm_backend`` of the arch
with the cut applied; the reference's ``reference/deepseek_v2.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from ehfl_bench.world import seed_words

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dims(model: Dict[str, Any]):
    m = model
    return (m["hidden_size"], m["num_attention_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"])


def leaf_shapes(model: Dict[str, Any]) -> Dict[str, tuple]:
    """The program's flat leaf names and their shapes."""
    d, nh, r, nope, rope, vd = _dims(model)
    m = model
    ff, held = m["moe_intermediate_size"], m["experts_held"]
    shapes = {"embed": (m["vocab_size"], d), "final_norm.scale": (d,), "lm_head": (m["vocab_size"], d)}
    for i in range(m["num_hidden_layers"]):
        pre = f"layers.{i}."
        shapes.update({pre + "norm1.scale": (d,), pre + "attn.wq": (d, nh * (nope + rope)),
                       pre + "attn.wkv_a": (d, r + rope), pre + "attn.kv_norm.scale": (r,),
                       pre + "attn.wkv_b": (r, nh * (nope + vd)), pre + "attn.wo": (nh * vd, d),
                       pre + "norm2.scale": (d,)})
        if i < m["first_k_dense_replace"]:
            w = m["intermediate_size"]
            shapes.update({pre + "mlp.w_gate": (d, w), pre + "mlp.w_up": (d, w), pre + "mlp.w_down": (w, d)})
        else:
            sw = ff * m["n_shared_experts"]
            shapes.update({pre + "moe.router": (d, m["n_routed_experts"]), pre + "moe.w_gate": (held, d, ff),
                           pre + "moe.w_up": (held, d, ff), pre + "moe.w_down": (held, ff, d),
                           pre + "moe.shared.w_gate": (d, sw), pre + "moe.shared.w_up": (d, sw),
                           pre + "moe.shared.w_down": (sw, d)})
    return shapes


def _fp32_leaf(name: str) -> bool:
    return name.endswith(".router")


def init_params(model: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf from its own normal draw on the device (one generator,
    leaves in name order), scaled as the port initialises, then cast."""
    dtype = DTYPES[model["dtype"]]
    g = torch.Generator(device=device).manual_seed(seed_words(seed, 1))
    out = {}
    for name, shape in leaf_shapes(model).items():
        if name.endswith("scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=g, device=device)
        if name in ("embed", "lm_head"):
            w = w.mul_(0.02)
        else:
            w = w.mul_(1.0 / math.sqrt(shape[-2]))  # fan_in: the input dim of a dense weight or an expert stack
        out[name] = w if _fp32_leaf(name) else w.to(dtype)
    return out


def make_data(model: Dict[str, Any], ehfl: Dict[str, Any], n_clients: int, seed: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Client sequences (N, n, S) as float32 ids with zero labels (N, n), and
    a test set of one sequence a client (N, S) with its next token."""
    V, S, n = model["vocab_size"], model["seq_len"], ehfl["samples_per_client"]
    g = torch.Generator(device=device).manual_seed(seed_words(seed, 0))
    topic_of_token = torch.randint(0, ehfl["topics"], (V,), generator=g, device=device)
    mix = np.random.default_rng(seed_words(seed, 4)).dirichlet(np.full(ehfl["topics"], ehfl["alpha"]), size=n_clients)
    probs = torch.as_tensor(mix, device=device)[:, topic_of_token]
    probs = probs / probs.sum(dim=-1, keepdim=True)
    tokens = torch.multinomial(probs, n * S, replacement=True, generator=g).reshape(n_clients, n, S)
    test = torch.multinomial(probs, S + 1, replacement=True, generator=g)
    return {"images": tokens.float(), "labels": torch.zeros(n_clients, n, dtype=torch.int64, device=device),
            "test_images": test[:, :S].float(), "test_labels": test[:, S].long()}


def port_config(model: Dict[str, Any]):
    """The registered arch with the ``model`` section's numbers laid on it:
    at the configuration's own size that changes only the cut (the layers,
    experts and vocabulary held here); at the CPU tests' ``tiny`` size the
    widths too."""
    from repro_torch.configs import YaRN, get_config

    m = model
    rs = m.get("rope_scaling")
    yarn = None if not rs else YaRN(
        factor=float(rs["factor"]), original_max_position=rs["original_max_position_embeddings"],
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]), mscale=float(rs["mscale"]),
        mscale_all_dim=float(rs["mscale_all_dim"]))
    return dataclasses.replace(
        get_config(m["arch"]), num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        num_heads=m["num_attention_heads"], num_kv_heads=m["num_attention_heads"],
        head_dim=m["qk_nope_head_dim"] + m["qk_rope_head_dim"], kv_lora_rank=m["kv_lora_rank"],
        q_head_dim_nope=m["qk_nope_head_dim"], q_head_dim_rope=m["qk_rope_head_dim"], v_head_dim=m["v_head_dim"],
        d_ff=m["moe_intermediate_size"], dense_d_ff=m["intermediate_size"],
        first_dense_layers=m["first_k_dense_replace"],
        num_experts=m["n_routed_experts"], experts_per_token=m["num_experts_per_tok"],
        num_shared_experts=m["n_shared_experts"], experts_held=m["experts_held"], expert_offset=m["expert_offset"],
        aux_weight=m["aux_loss_alpha"],
        vocab_size=m["vocab_size"], norm_eps=m["rms_norm_eps"], rope_theta=float(m["rope_theta"]),
        rope_scaling=yarn, dtype=DTYPES[m["dtype"]])


def backend(model: Dict[str, Any]):
    from repro_torch.fl.backend import lm_backend

    return lm_backend(port_config(model))


def reference(model: Dict[str, Any], rounding: bool = False):
    from ehfl_bench.reference.deepseek_v2 import DeepSeekV2

    return DeepSeekV2(model, rounding=rounding)


def param_count(model: Dict[str, Any]) -> int:
    return sum(math.prod(s) for s in leaf_shapes(model).values())


def forward_flops(model: Dict[str, Any]) -> int:
    """FLOPs of one sequence's forward at ``seq_len``: 2 per multiply-add of
    every projection, the causal half of the attention core (S (S + 1) / 2
    query-key pairs), the router, the shared experts, the routed experts at
    k x held / E rows a token (the rows a token's choices give here, not
    the rows the program pads to), and the head.  Norms, softmaxes and the
    rope not counted."""
    d, nh, r, nope, rope, vd = _dims(model)
    m, S = model, model["seq_len"]
    attn_proj = d * nh * (nope + rope) + d * (r + rope) + r * nh * (nope + vd) + nh * vd * d
    core = nh * ((nope + rope) + vd) * S * (S + 1) // 2
    per_token = 0
    for i in range(m["num_hidden_layers"]):
        per_token += attn_proj
        if i < m["first_k_dense_replace"]:
            per_token += 3 * d * m["intermediate_size"]
        else:
            ff, E = m["moe_intermediate_size"], m["n_routed_experts"]
            per_token += d * E + 3 * d * ff * m["n_shared_experts"]
            per_token += 3 * d * ff * m["num_experts_per_tok"] * m["experts_held"] // E
    per_token += d * m["vocab_size"]
    return 2 * (S * per_token + m["num_hidden_layers"] * core)


def useful_flops(cell: Dict[str, Any], cfg, n_epochs: int, n_started: int, n_evals: int) -> float:
    """The useful FLOPs of ``n_epochs`` epochs that started ``n_started``
    clients, with ``n_evals`` evaluations: the probe over N x probe_size
    sequences an epoch (VAoI), 3 forwards' worth a trained sequence
    (forward and backward) and one more for the Eq. 6 feature tap (VAoI),
    the eval's forward over the test set.  Padding lanes not counted."""
    model, ehfl = cell["model_config"]["model"], cell["model_config"]["ehfl"]
    fwd = forward_flops(model)
    vaoi = cfg.policy == "vaoi"
    bs = max(1, ehfl["samples_per_client"] // cfg.kappa)
    per_client = cfg.kappa * bs * fwd * (4 if vaoi else 3)
    probe = cfg.num_clients * cfg.probe_size * fwd if vaoi else 0
    return float(n_started * per_client + n_epochs * probe + n_evals * cfg.num_clients * fwd)


def leaf_bytes(model: Dict[str, Any]) -> Dict[str, tuple]:
    """Columns and element size of each leaf dtype group the FedAvg kernel
    reduces: the model dtype's, and the fp32 routers'."""
    shapes = leaf_shapes(model)
    routers = sum(math.prod(s) for k, s in shapes.items() if _fp32_leaf(k))
    elt = DTYPES[model["dtype"]].itemsize
    return {model["dtype"]: (param_count(model) - routers, elt), "float32": (routers, 4)}


def feature_dim(model: Dict[str, Any]) -> int:
    return model["vocab_size"]


def feature_bytes() -> int:
    """Bytes of an element of the probe's features (fp32 softmax means)."""
    return 4
