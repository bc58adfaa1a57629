#!/usr/bin/env python3
"""Time the attention forward's wgmma route on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/attn_forward_times.py [--rounds 4] [--reps 20] [--seed 0]

Cases, all bfloat16 at the models' blocks (128, 128), causal:

* ``problem``: (1, 32, 4096, 4096, 128), no softcap (chip_smoke's
  ``ATTN_PROBLEM``);
* ``gemma2_local`` and ``gemma2_global``: gemma2-27b's two layer kinds at
  8192 tokens, 32 query heads over 16 kv heads, D 128, softcap 50, window
  4096 and none.

Each case is first held against ``flash_attention_plain`` at the same kv
block (normwise within 2^-12, chip_smoke's bfloat16 gate), then timed as
``--rounds`` medians of ``--reps`` calls, each call between CUDA events.
The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout's path, and per case its
route, error and medians.  The kernels build from the checkout's
``csrc/`` into its ``build/`` at first use.  To compare two checkouts,
run the script from each on one card in one session, alternating (A, B,
B, A), and compare the times only within that session.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

D = 128
BLOCK = 128
TOL = 2.0 ** -12
CASES = {
    "problem": dict(hq=32, hkv=32, s=4096, window=0, softcap=0.0),
    "gemma2_local": dict(hq=32, hkv=16, s=8192, window=4096, softcap=50.0),
    "gemma2_global": dict(hq=32, hkv=16, s=8192, window=0, softcap=50.0),
}


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls, each call
    between CUDA events, after one call to warm up."""
    import torch
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("attn_forward_times: no CUDA device")
    from repro_torch.kernels.flash_attention import (attn_route,
                                                     flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = {}
    for name, c in CASES.items():
        q, k, v = (torch.randn(1, heads, c["s"], D, generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for heads in (c["hq"], c["hkv"], c["hkv"]))
        kw = dict(causal=True, window=c["window"], softcap=c["softcap"])
        out = flash_attention(q, k, v, bq=BLOCK, bkv=BLOCK, **kw).float()
        ref = flash_attention_plain(q, k, v, bkv=BLOCK, **kw).float()
        err = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        del out, ref
        if not err <= TOL:
            raise AssertionError(f"{name}: the kernel disagrees with its "
                                 f"plain version, normwise {err:.3e} "
                                 f"(bound {TOL:.3e})")
        medians = [median_ms(lambda: flash_attention(
            q, k, v, bq=BLOCK, bkv=BLOCK, **kw), args.reps)
            for _ in range(args.rounds)]
        cases[name] = {"route": attn_route(torch.bfloat16, BLOCK, BLOCK, D),
                       "normwise": err, "median_ms": medians, **c}
        print(f"{name}: normwise {err:.3e}, medians (ms) "
              + ", ".join(f"{m:.4f}" for m in medians), flush=True)
        del q, k, v
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "checkout": str(ROOT), "cases": cases}))


if __name__ == "__main__":
    main()
