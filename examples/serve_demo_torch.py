"""Batched serving demo on the PyTorch/CUDA port: decode-based prefill, then
greedy decode against the SSM or KV cache, with the reduced config.

  PYTHONPATH=src python examples/serve_demo_torch.py --tokens 16               # on the GPU
  PYTHONPATH=src python examples/serve_demo_torch.py --tokens 16 --device cpu
  PYTHONPATH=src python examples/serve_demo_torch.py --arch starcoder2-3b --device cpu

The counterpart of ``examples/serve_demo.py``.  The port has the SSM family
(``mamba2-1.3b``) and dense attention (``starcoder2-3b``, whose sliding
window makes its KV cache a rolling buffer); other archs raise until their
layers are ported.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import decoder


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b", help="mamba2-1.3b or starcoder2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = decoder.init_params(cfg, seed=args.seed, device=device)
    B, P = args.batch, args.prompt_len
    g = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=device)

    cache = decoder.init_cache(cfg, B, P + args.tokens, device=device)
    step = make_serve_step(cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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
    out = torch.cat(generated, dim=1)
    print(f"decoded {args.tokens-1} tokens x batch {B} in {dt:.2f}s "
          f"({B*(args.tokens-1)/max(dt,1e-9):.1f} tok/s on {device.type}, reduced config)")
    for b in range(B):
        print(f"  seq[{b}]: {out[b].tolist()}")


if __name__ == "__main__":
    main()
