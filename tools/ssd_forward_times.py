#!/usr/bin/env python3
"""Time the SSD forward's kernels on a CUDA card at mamba2-2.7b's width.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_forward_times.py [--rounds 3] [--reps 20] [--seed 0]

The problem is chip_smoke's ``SSD_PROBLEM``, mamba2-2.7b's (batch, L, H,
P, G, N) = (1, 4096, 80, 64, 1, 128) in float32, with the reference
test's operands (dt = |N(0, 1)| 0.1, a_log = N(0, 1) 0.5, x, b, c standard
normal), at chunks 64 and 256 (the model's).  At each chunk the forward
(``ssd``) is first held against ``ssd_plain`` (normwise within 1e-5,
chip_smoke's float32 gate), then timed whole, and each pass alone at
every head count a block may take: pass 1 (the chunk state) at 1 and 2
heads, pass 3 (the chunk scan) at 1, 2 and 4, each held against the
default's output bits first (the head count changes which block computes
a head, not its arithmetic).  Times are ``--rounds`` medians of
``--reps`` calls, each call between CUDA events.  The last line of the
output is one JSON object: the card's name and power limit as
``nvidia-smi`` prints them, the checkout's path, and per chunk the error,
the head counts the wrapper picks, and the medians.  The kernels build
from the checkout's ``csrc/`` into its ``build/`` at first use.  Compare
two checkouts only within one session on one card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

PROBLEM = (1, 4096, 80, 64, 1, 128)
CHUNKS = (64, 256)
TOL = 1e-5
STATE_HEADS = (1, 2)
SCAN_HEADS = (1, 2, 4)


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


def operands(seed: int):
    """The reference test's operands at PROBLEM on the card."""
    import numpy as np
    import torch
    b, l, h, p, g, n = PROBLEM
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, l, h, p)),
              np.abs(rng.standard_normal((b, l, h))) * 0.1,
              rng.standard_normal((h,)) * 0.5,
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, l, g, n)))
    return [torch.from_numpy(a.astype(np.float32)).to("cuda")
            for a in arrays]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_forward_times: no CUDA device")
    from repro_torch.kernels.ssd import (_launch_chunk_scan,
                                         _launch_chunk_state,
                                         _launch_state_pass, ssd, ssd_plain,
                                         ssd_scan_heads, ssd_scratch,
                                         ssd_state_heads)
    x, dt, a_log, bb, cc = ops = operands(args.seed)
    _, _, h, _, g, _ = PROBLEM
    out = {}
    for chunk in CHUNKS:
        got = ssd(*ops, chunk=chunk)
        torch.cuda.synchronize()
        want = ssd_plain(*ops, chunk=chunk)
        err = float((got - want).norm() / want.norm())
        if not err <= TOL:
            sys.exit(f"ssd_forward_times: chunk {chunk}: normwise {err:.3e}"
                     f" from ssd_plain, over {TOL}")
        s, states = ssd_scratch(x, bb, chunk)
        y = torch.empty_like(x)
        ref_states = torch.empty_like(states)
        _launch_chunk_state(x, dt, a_log, bb, s, ref_states, chunk)
        passes = {}
        for heads in STATE_HEADS:
            _launch_chunk_state(x, dt, a_log, bb, s, states, chunk, heads)
            torch.cuda.synchronize()
            if not torch.equal(states, ref_states):
                sys.exit(f"ssd_forward_times: pass 1 at {heads} heads a "
                         f"block is not the default's bits")
            passes[f"chunk_state_{heads}"] = [median_ms(
                lambda: _launch_chunk_state(x, dt, a_log, bb, s, states,
                                            chunk, heads), args.reps)
                for _ in range(args.rounds)]
        _launch_state_pass(s, states, chunk)
        passes["state_pass"] = [median_ms(
            lambda: _launch_state_pass(s, ref_states, chunk), args.reps)
            for _ in range(args.rounds)]
        for heads in SCAN_HEADS:
            _launch_chunk_scan(x, dt, bb, cc, s, states, y, chunk, heads)
            torch.cuda.synchronize()
            if not torch.equal(y, got):
                sys.exit(f"ssd_forward_times: pass 3 at {heads} heads a "
                         f"block is not the default's bits")
            passes[f"chunk_scan_{heads}"] = [median_ms(
                lambda: _launch_chunk_scan(x, dt, bb, cc, s, states, y,
                                           chunk, heads), args.reps)
                for _ in range(args.rounds)]
        whole = [median_ms(lambda: ssd(*ops, chunk=chunk), args.reps)
                 for _ in range(args.rounds)]
        out[chunk] = {"normwise": err, "forward_ms": whole,
                      "heads": {"chunk_state": ssd_state_heads(h, g),
                                "chunk_scan": ssd_scan_heads(h, g)},
                      "passes_ms": passes}
        print(f"chunk {chunk}: normwise {err:.3e}; forward "
              + " / ".join(f"{t:.4f}" for t in whole) + " ms; " + "; ".join(
                  f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                  for k, v in passes.items()), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "checkout": str(ROOT),
                      "problem": list(PROBLEM), "chunks": out}))


if __name__ == "__main__":
    main()
