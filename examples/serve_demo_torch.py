"""Batched serving demo on the PyTorch/CUDA port: decode-based prefill, then
greedy decode against the SSM or KV cache, with the reduced config.

  PYTHONPATH=src python examples/serve_demo_torch.py --tokens 16               # on the GPU
  PYTHONPATH=src python examples/serve_demo_torch.py --tokens 16 --device cpu
  PYTHONPATH=src python examples/serve_demo_torch.py --arch whisper-large-v3 --device cpu

The counterpart of ``examples/serve_demo.py``; ``--arch`` takes every
registered arch.  A VLM (``internvl2-2b``) first runs the prefill step over
prefix embeddings + the prompt and prints its next token; its decode has no
prefix path (nor has the reference's), so the steps run over the prompt.
An encoder-decoder (``whisper-large-v3``) encodes its frames and fills the
cross-attention K/V cache before the steps.  Prefix embeddings and frames
stand in for the stubbed frontends and are drawn from ``--seed``.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decoder


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b", choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = decoder.init_params(cfg, seed=args.seed, device=device, max_seq=256)
    B, P = args.batch, args.prompt_len
    g = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"arch": cfg.name, "family": cfg.family}
    cache = decoder.init_cache(cfg, B, P + args.tokens, device=device, cross_cache=cfg.is_encoder_decoder)
    if cfg.num_prefix_tokens:
        prefix = torch.randn(B, cfg.num_prefix_tokens, cfg.d_model, generator=g, device=device) * 0.02
        logits = make_prefill_step(cfg)(params, {"tokens": prompts, "prefix_embeddings": prefix})
        out["prefix_next"] = torch.argmax(logits[:, -1], dim=-1).tolist()
        print(f"prefill over {cfg.num_prefix_tokens} prefix embeddings + {P} tokens: next {out['prefix_next']}")
    if cfg.is_encoder_decoder:
        frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=g, device=device) * 0.5
        with torch.inference_mode():
            cache = decoder.prefill_cross_cache(cfg, params, cache, decoder.encode(cfg, params, frames))
        print(f"encoded {cfg.encoder_seq} frames; cross K/V cached in {cfg.num_layers} layers")
    step = make_serve_step(cfg)

    # prefill by stepping the prompt through the cache (decode-based prefill)
    t0 = time.time()
    for t in range(P):
        logits, cache = step(params, cache, prompts[:, t : t + 1], torch.full((B,), t, device=device))
    sync()
    print(f"prefill({P} tokens): {time.time()-t0:.2f}s")

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    generated = [tok]
    t0 = time.time()
    for t in range(P, P + args.tokens - 1):
        logits, cache = step(params, cache, tok, torch.full((B,), t, device=device))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    sync()
    dt = time.time() - t0
    tokens = torch.cat(generated, dim=1)
    print(f"decoded {args.tokens-1} tokens x batch {B} in {dt:.2f}s "
          f"({B*(args.tokens-1)/max(dt,1e-9):.1f} tok/s on {device.type}, reduced config)")
    for b in range(B):
        print(f"  seq[{b}]: {tokens[b].tolist()}")
    out["tokens"] = tokens.tolist()
    return out


if __name__ == "__main__":
    main()
