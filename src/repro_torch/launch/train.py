"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Mirrors ``repro.launch.train``.  Without ``--full-config`` it trains the
reduced config of the family (``--d-model``, ``--layers``, vocab 512);
with it, the architecture at full width, cut to ``--layers`` layers when
given.  It runs on the card unless ``--device cpu``: attention layers
through the flash-attention kernels and their backward, Mamba layers
through the SSD kernels and theirs (mamba2-2.7b trains on the card).
For example::

    python -m repro_torch.launch.train --arch gemma2-27b --full-config \\
        --layers 4 --batch 1 --seq 4096 --steps 8 --dtype bfloat16
    python -m repro_torch.launch.train --arch mamba2-2.7b --full-config \\
        --batch 1 --seq 4096 --steps 8 --dtype bfloat16
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_config, reduced
from ..train.data import DataConfig
from ..train.optimizer import AdamW
from ..train.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="the architecture at full width")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: 2 reduced, the config's own full)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg, n_layers=args.layers or 2, d_model=args.d_model,
                      d_ff=4 * args.d_model, vocab=512)
    elif args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch,
                          frontend_dim=cfg.frontend_dim
                          if cfg.frontend != "none" else 0)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     log_every=10)
    opt = AdamW(lr=args.lr)
    _, _, report = train(cfg, data_cfg, tc, opt=opt,
                         dtype=getattr(torch, args.dtype),
                         device=args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} steps={len(report.losses)}"
          f" first_loss={report.losses[0]:.4f} "
          f"final_loss={report.final_loss:.4f} "
          f"resumed_from={report.resumed_from} "
          f"stragglers={len(report.straggler_steps)}")


if __name__ == "__main__":
    main()
