#!/usr/bin/env python3
"""Run one of chip_smoke's phase-12 model runs alone on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/model_cell_times.py [--arch mamba2-2.7b] [--checkout DIR]

Runs ``drive_model`` from the checkout's own ``chip_smoke.py`` for the
``MODEL_RUNS`` entry of ``--arch`` (gemma2-27b: bf16, 1 x 8192 tokens;
mamba2-2.7b: f32, 2 x 4096), in this process and nothing else beside it:
its kernels built from the checkout's ``csrc/`` into its ``build/``, then
random parameters at full width and depth, three prefills (first, timed,
profiled) and DECODE_STEPS greedy decode steps with one more profiled.

The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout, the prefill's and the
decode step's times (ms), and each profile's device time by class and
idle share.  To compare two checkouts, run the script for each on one
card in one command, alternating (A, B, B, A), one process each, and
compare the times only within that command.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("model_cell_times: no CUDA device")
    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.perf.roofline import card_of
    runs = {r[0]: (seed, r) for seed, r in enumerate(chip_smoke.MODEL_RUNS)}
    seed, (arch, dtype, batch, s) = runs[args.arch]
    _build.build_all(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    dev = resolve_device("cuda")
    res = chip_smoke.drive_model(dev, card_of(dev), arch, dtype, batch, s,
                                 seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    def brief(prof):
        return {k: prof.get(k) for k in ("wall_ms", "busy_ms", "idle_share",
                                         "by_class_ms")}

    print(json.dumps({
        "card": card, "checkout": str(root), "arch": arch, "dtype": dtype,
        "batch": batch, "prompt": s, "prefill_ms": res["prefill_ms"],
        "decode_ms": res["decode_ms"],
        "decode_steps_ms": res["decode_steps_ms"],
        "prefill_profile": brief(res["profile"]),
        "decode_profile": brief(res["decode_profile"])}))


if __name__ == "__main__":
    main()
