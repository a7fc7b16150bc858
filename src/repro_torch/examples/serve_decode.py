"""Batched serving example: prefill + greedy decode with KV caches on a
reduced assigned architecture.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode \
      --arch gemma3-27b [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.launch.serve import generate
from repro_torch.models import SplitModel
from repro_torch.models.frontends import synth_frontend_embeds
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_reduced(get_config(args.arch))
    model = SplitModel(cfg)
    params = model.init(0, device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    prefix = (synth_frontend_embeds(cfg, gen, args.batch, device=device)
              if cfg.frontend else None)

    t0 = time.time()
    out = generate(cfg, params, tokens, steps=args.gen, prefix=prefix)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"arch={args.arch} (reduced) batch={args.batch}")
    print("first sequences:", out[:2].tolist())
    print(f"{args.batch * args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {device.type})")
    return out


if __name__ == "__main__":
    main()
