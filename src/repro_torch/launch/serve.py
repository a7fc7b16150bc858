"""Batched serving driver: prefill a batch of prompts, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch internlm2-1.8b --batch 4 --prompt-len 32 --gen 16

``--device`` defaults to ``cuda`` and raises without a card. The flags
are the reference's: its ``--reduced`` is a ``store_true`` flag that
defaults to True, so this CLI, like the reference's, always serves the
reduced variant; serve a full config by calling ``generate`` directly
(``chip_smoke.py`` does). Greedy decoding is the reference's; sampling
at a temperature draws from a ``torch.Generator`` seeded from ``seed``,
whose stream cannot equal JAX's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.models import SplitModel
from repro_torch.models import transformer as tf_mod
from repro_torch.models.frontends import synth_frontend_embeds
from repro_torch.utils.device import resolve_device


@torch.no_grad()
def generate(cfg, params, tokens, *, steps: int, prefix=None,
             temperature: float = 0.0, seed: int = 0):
    """Greedy/temperature decode. Returns (B, steps) generated tokens."""
    B, S = tokens.shape
    max_len = S + steps + (cfg.n_frontend_tokens if cfg.frontend else 0)
    logits, caches, n_pre = tf_mod.prefill(cfg, params, tokens, max_len,
                                           prefix)
    gen = torch.Generator(device=tokens.device).manual_seed(int(seed))
    out = []
    for t in range(steps):
        lg = logits[:, -1, :cfg.vocab_size]
        if temperature > 0:
            probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(lg, dim=-1)[:, None]
        out.append(tok)
        logits, caches = tf_mod.decode_step(cfg, params, tok, caches,
                                            n_pre + t)
    return torch.cat(out, dim=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = SplitModel(cfg)
    params = model.init(0, device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    prefix = (synth_frontend_embeds(cfg, gen, args.batch, device=device)
              if cfg.frontend else None)
    t0 = time.time()
    out = generate(cfg, params, tokens, steps=args.gen, prefix=prefix,
                   temperature=args.temperature)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print("generated:", out[:2].tolist())
    print(f"{args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
