#!/usr/bin/env python3
"""Run one of chip_smoke's train cells alone on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/train_cell_times.py [--cell 15c] [--checkout DIR]

Runs the cell's function from the checkout's own ``chip_smoke.py`` (14c
``train_path``: gemma2-27b's layers; 15c ``ssd_train_path``: mamba2-2.7b's
64 layers; 16c ``moe_train_path``: jamba-v0.1-52b's layers 3-4), in this
process and nothing else beside it: its kernels built from the checkout's
``csrc/`` into its ``build/``, then the cell's AdamW steps through
``train()`` and one more step under ``torch.profiler``, with chip_smoke's
own checks.  A cell's host time depends on what ran before it in the same
process; this is its time with nothing before it.

The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout, the cell, its step
times (ms), their median, its losses, its parameter tensors and peak
device memory, and the profiled step's wall, device-busy and idle share,
its device time by class, its longest kernels and the optimizer's host
time (where the checkout's profile records them).  Only the kernels whose sources the checkout holds
are built, so an older checkout runs too.  To compare two checkouts, run
the script for each on one card in one command, alternating (A, B, B,
A), one process each, and compare the times only within that command.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

#: chip_smoke's train cells: (its function, the kernels it launches)
CELLS = {"14c": ("train_path", ["flash_attention", "flash_attention_bwd",
                                "adamw", "rmsnorm"]),
         "15c": ("ssd_train_path", ["ssd", "ssd_bwd", "adamw",
                                    "mamba_mixer", "rmsnorm"]),
         "16c": ("moe_train_path", ["flash_attention", "flash_attention_bwd",
                                    "ssd", "ssd_bwd", "adamw",
                                    "mamba_mixer", "rmsnorm"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="15c")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_cell_times: no CUDA device")
    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.perf.roofline import card_of
    fn_name, kernels = CELLS[args.cell]
    _build.build_all([k for k in kernels if (_build.CSRC / f"{k}.cu")
                      .exists()])
    dev = resolve_device("cuda")
    res = getattr(chip_smoke, fn_name)(dev, card_of(dev))
    prof = res["profile"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "checkout": str(root), "cell": args.cell,
        "steps_ms": res["steps_ms"], "step_ms_median": res["step_ms_median"],
        "losses": res["losses"], "tensors": res.get("tensors"),
        "peak_bytes": res["peak_bytes"],
        "profiled": {k: prof.get(k) for k in (
            "wall_ms", "busy_ms", "idle_share", "by_class_ms",
            "top_kernels_ms", "adamw_host_ms")}}))


if __name__ == "__main__":
    main()
