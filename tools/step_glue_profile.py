#!/usr/bin/env python3
"""Split a chip_smoke train cell's device time by the model code behind it.

Usage, from the root of a checkout on a machine with a CUDA card::

    python3 tools/step_glue_profile.py [--cell 15c] [--checkout DIR]

Builds the cell of the checkout's own ``chip_smoke.py`` (14c gemma2-27b's
layers, 15c mamba2-2.7b's 64 layers, 16c jamba-v0.1-52b's layers 3-4, at
full width, bfloat16, batch 1 x 4096 tokens), trains it WARM_STEPS steps
through ``train()`` and runs one more step under ``torch.profiler`` with
``record_shapes``.  While it runs, the model's pieces are wrapped in
``record_function`` ranges (this script's own wrappers of the module
globals, nothing in the package changes): ``glue:rmsnorm`` (the block and
final ``rmsnorm``), ``glue:mamba`` (``mamba_forward``), ``glue:attn``,
``glue:ffn``, ``glue:block`` (the rest of a block: the residual adds),
``glue:embed`` and ``glue:ce`` (the chunked cross entropy); the optimizer
is chip_smoke's marked AdamW (``adamw``).

Each device kernel is charged to the range around the operator that
launched it; a kernel of the backward is charged, through its autograd
node's sequence number, to the range of the forward operator that made the
node (a remat recompute runs inside the ranges again).  Kernels are
classed as chip_smoke's ``kernel_class`` classes them.

Prints the card's name and power limit, then the step's device time by
range and class, the longest "other" kernels with the operators (name,
input shapes, range, forward or backward) that launched them, and, as the
last line, all of it as one JSON object (also written to
``chiprun_out/step_glue_profile_<cell>.json`` under the checkout given).
"""
import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

#: steps through train() before the profiled one
WARM_STEPS = 2
#: the module globals of ``models.transformer`` wrapped in ranges
WRAPPED = {"rmsnorm": "glue:rmsnorm", "mamba_forward": "glue:mamba",
           "attn_forward": "glue:attn", "_ffn": "glue:ffn",
           "_block_body": "glue:block", "_embed": "glue:embed",
           "chunked_cross_entropy": "glue:ce"}
BACKWARD = "autograd::engine::evaluate_function: "


def cell_config(chip_smoke, cell: str):
    import dataclasses
    from repro_torch.configs import get_config
    if cell == "14c":
        base = get_config(chip_smoke.TRAIN_ARCH)
        return dataclasses.replace(base, n_layers=chip_smoke.TRAIN_PERIODS *
                                   len(base.block_pattern))
    if cell == "15c":
        return dataclasses.replace(get_config(chip_smoke.SSD_TRAIN_ARCH),
                                   n_layers=chip_smoke.SSD_TRAIN_LAYERS)
    return chip_smoke.moe_cell_config()


def wrap_ranges():
    """Wrap ``models.transformer``'s globals in WRAPPED in ranges."""
    import functools
    import torch
    from repro_torch.models import transformer

    def ranged(fn, label):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    for name, label in WRAPPED.items():
        setattr(transformer, name, ranged(getattr(transformer, name), label))


def label_of(evt):
    """(range, backward node or None) of a CPU event: the innermost range
    above it, and the autograd node's event when one lies below that
    range (a backward operator, not a recompute)."""
    node = None
    e = evt
    while e is not None:
        if e.name.startswith("glue:") or e.name == "adamw":
            return e.name, node
        if node is None and e.name.startswith(BACKWARD):
            node = e
        e = e.cpu_parent
    return None, node


def attribute(events, kernel_class):
    """Device ms by (range, class, direction) and the operators behind
    each kernel name."""
    fwd_label = {}
    for e in events:
        if e.device_type.name != "CPU" or e.sequence_nr < 0:
            continue
        label, node = label_of(e)
        if label is not None and node is None:
            fwd_label.setdefault((e.thread, e.sequence_nr), label)
            fwd_label.setdefault(("any", e.sequence_nr), label)
    by = collections.defaultdict(float)
    ops = collections.defaultdict(lambda: collections.defaultdict(float))
    for e in events:
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        label, node = label_of(e)
        direction = "forward"
        if node is not None:
            direction = "backward"
            label = fwd_label.get((node.fwd_thread, node.sequence_nr)) or \
                fwd_label.get(("any", node.sequence_nr)) or "unlabelled"
        elif label is None:
            label = "unlabelled"
        for k in e.kernels:
            ms = k.duration / 1e3
            cls = kernel_class(k.name)
            if label == "adamw":
                cls = "adamw"
            by[(label, cls, direction)] += ms
            op = e.name + (f" [{node.name[len(BACKWARD):]}]" if node else "")
            shapes = str([s for s in (e.input_shapes or []) if s])[:120]
            ops[k.name[:80]][(op, shapes, label, direction)] += ms
    return by, ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("14c", "15c", "16c"), default="15c")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_glue_profile: no CUDA device")
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.data import DataConfig, batch_at, to_device
    from repro_torch.train.train_loop import TrainConfig, train
    _build.build_all(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = cell_config(chip_smoke, args.cell)
    wrap_ranges()
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=chip_smoke.TRAIN_SEQ,
                          global_batch=1, seed=0)
    opt = chip_smoke.marked_adamw(chip_smoke.TRAIN_LR)
    params, opt_state, _ = train(cfg, data_cfg,
                                 TrainConfig(steps=WARM_STEPS), opt=opt,
                                 dtype=torch.bfloat16, device=dev)
    step_fn = make_train_step(cfg, opt)
    batch = to_device(batch_at(data_cfg, WARM_STEPS), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by, ops = attribute(prof.events(), chip_smoke.kernel_class)
    busy = sum(by.values())
    by_class = collections.defaultdict(float)
    other = collections.defaultdict(float)
    for (label, cls, direction), ms in by.items():
        by_class[cls] += ms
        if cls == "other":
            other[f"{label} {direction}"] += ms
    by_kernel = {k: sum(v.values()) for k, v in ops.items()}
    top = sorted(by_kernel, key=lambda k: -by_kernel[k])
    top_other = [k for k in top if chip_smoke.kernel_class(k) == "other"]
    out = {
        "card": card, "checkout": str(root), "cell": args.cell,
        "arch": cfg.name, "layers": cfg.n_layers, "wall_ms": wall_ms,
        "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "by_class_ms": dict(by_class),
        "other_by_range_ms": dict(sorted(other.items(),
                                         key=lambda kv: -kv[1])),
        "by_range_class_ms": {" | ".join(k): v for k, v in sorted(
            by.items(), key=lambda kv: -kv[1])},
        "top_other_kernels": [{
            "kernel": k, "ms": by_kernel[k],
            "ops": [{"op": op, "shapes": sh, "range": lb, "direction": d,
                     "ms": ms} for (op, sh, lb, d), ms in sorted(
                         ops[k].items(), key=lambda kv: -kv[1])[:6]]}
            for k in top_other[:args.top]]}
    print(f"{args.cell} {cfg.name} ({cfg.n_layers} layers): wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{100 * out['idle_share']:.1f} %")
    print("  by class: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
        by_class.items(), key=lambda kv: -kv[1])))
    print("  other by range: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["other_by_range_ms"].items()))
    for row in out["top_other_kernels"]:
        print(f"  {row['kernel']} {row['ms']:.1f} ms")
        for o in row["ops"]:
            print(f"    {o['ms']:.1f} ms {o['op']} {o['shapes']} "
                  f"{o['range']} {o['direction']}")
    dest = root / "chiprun_out" / f"step_glue_profile_{args.cell}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
