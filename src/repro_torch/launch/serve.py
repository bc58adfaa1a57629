"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Mirrors ``repro.launch.serve``: the reduced config of the family, random
float32 parameters from a seeded generator, ``--requests`` prompts of
``--prompt-len`` random tokens, each asking ``--max-new`` tokens, served by
the port's :class:`~repro_torch.serve.engine.ServeEngine` under FIFO; it
prints the reference's line.  It runs on the card unless ``--device cpu``::

    python -m repro_torch.launch.serve --arch gemma2-27b
    python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config, reduced
from ..models import init_params
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, torch.float32, device=device)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         ctx_len=args.ctx, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    stats = engine.run(reqs)
    for r in reqs:
        assert r.done and len(r.out_tokens) == args.max_new
    print(f"arch={cfg.name} requests={len(reqs)} "
          f"decode_steps={stats.decode_steps} "
          f"tokens={stats.tokens_out} tok/s={stats.tokens_per_s:.1f}")


if __name__ == "__main__":
    main()
