"""Batched serving driver: prefill + greedy decode loop (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --batch 4 --prompt-len 128 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

Runs the serve_prefill / serve_step functions of ``launch/steps.py`` on
fresh parameters from --seed and random prompt ids from the same seed;
prints the JAX package's lines (prefill and decode seconds, decode tokens
per second, a sample of generated ids) and returns the generated ids.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.tune import resolve_device
from repro_torch.launch.steps import make_serve_prefill, make_serve_step
from repro_torch.models import transformer as tf


def prompts(cfg, batch: int, length: int, seed: int, device):
    """(tokens (batch, length) int32, frames or None) from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)).to(device)
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).to(device)
    return tokens, frames


def greedy_generate(params, cfg, tokens, gen: int, frames=None):
    """Prefill ``tokens`` and greedy-decode ``gen`` ids.  Returns (ids
    (B, gen) int64 tensor, each step's logits [(B, V)], prefill seconds,
    decode seconds), host wall ending in a device sync."""
    pl = tokens.shape[1]
    prefill = make_serve_prefill(cfg, pl + gen)
    step = make_serve_step(cfg)
    sync = (torch.cuda.synchronize if tokens.is_cuda else (lambda: None))
    with torch.no_grad():
        sync()
        t0 = time.time()
        logits, caches = prefill(params, tokens, frames)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        out, step_logits = [nxt], [logits[:, -1]]
        sync()
        t_prefill = time.time() - t0

        t0 = time.time()
        for i in range(gen - 1):
            logits, caches = step(params, caches, nxt, pl + i)
            nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            step_logits.append(logits[:, 0])
        sync()
        t_decode = time.time() - t0
    return torch.cat(out, dim=1), step_logits, t_prefill, t_decode


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tf.init_model(args.seed, cfg, device=dev)
    if cfg.family == "hybrid" or cfg.family == "ssm":
        # chunked SSD wants seq % chunk == 0 at prefill
        pl = max(args.prompt_len - args.prompt_len % cfg.ssm_chunk,
                 cfg.ssm_chunk)
    else:
        pl = args.prompt_len
    tokens, frames = prompts(cfg, args.batch, pl, args.seed, dev)

    ids, _, t_prefill, t_decode = greedy_generate(params, cfg, tokens,
                                                  args.gen, frames)
    gen = ids.cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} prefill({pl} toks)={t_prefill:.2f}s "
          f"decode={t_decode:.2f}s ({tps:.1f} tok/s)")
    print(f"[serve] sample generated ids: {gen[0][:12].tolist()}")
    return gen


if __name__ == "__main__":
    main()
