"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on the
production mesh, the counterpart of ``repro/launch/dryrun.py``.

The reference forces 512 host devices and compiles each cell with XLA.
Here, for each cell, the driver

1. starts a ``"fake"`` process group of 256 or 512 ranks (no card, no
   network: a collective returns at once) and builds the production mesh
   (16 x 16, or 2 x 16 x 16 with a "pod" axis);
2. makes the parameters, the AdamW state, the inputs and the decode
   caches as fake ``DTensor``s (``FakeTensorMode``: shapes, no
   allocation), placed by :mod:`repro_torch.distributed.sharding`, on
   device "cuda", so the card's route is traced: the kernels'
   ``torch.library`` operators with their legality checks on the card
   (fake tensors run only the operators' fake implementations, never the
   plain versions);
3. runs one step under :class:`repro_torch.perf.roofline.StepRecorder`,
   which records one rank's FLOPs (``FlopCounterMode``'s formulas),
   bytes, collective operand bytes by kind and the peak of the tensors
   the step makes;
4. prints the roofline terms on the H100's rates
   (:func:`repro_torch.perf.roofline.extract`) and writes them to
   ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

These per-device numbers are traced counts on the card's published
rates, not measurements.  The reference's collectives come from XLA's
partitioner and these from ``DTensor``'s propagation, so the two
collective counts are not expected to agree.  A CPU-only PyTorch build
can fake a CUDA tensor but cannot differentiate one or shard it, so under
such a build the cells trace on fake CPU tensors (:func:`trace_device`),
through the same operators.

Usage::

    python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b --shape train_4k
    python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b \\
        --shape train_4k,prefill_32k,decode_32k --both-meshes [--out DIR]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist

from ..configs import SHAPES, all_configs, get_config
from ..distributed.sharding import (NamedSharding, Spec, cache_specs,
                                    data_specs, param_specs, placements,
                                    simple_batch_spec)
from ..perf.analytic import cell_cost
from ..perf.roofline import StepRecorder, extract, model_flops_for
from ..train.checkpoint import leaves, rebuild
from ..train.optimizer import AdamW
from .mesh import make_production_mesh
from .steps import (abstract_caches, abstract_params, input_specs,
                    make_prefill_step, make_serve_step, make_train_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def mesh_size_hint(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def trace_device() -> str:
    """The fake tensors' device: "cuda" (the card's route, its legality
    checks included) where PyTorch is built with CUDA, a card present or
    not; "cpu" under a CPU-only build, which cannot differentiate or shard
    a fake CUDA tensor."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def default_strategy(cfg, shape, multi_pod: bool) -> str:
    """The reference's defaults: "tp" for training, "serve" otherwise;
    dense single-pod training whose batch covers the mesh goes "dp"."""
    strategy = "tp" if shape.kind == "train" else "serve"
    if shape.kind == "train" and cfg.n_experts == 0 and not multi_pod \
            and shape.global_batch % mesh_size_hint(multi_pod) == 0:
        strategy = "dp"
    return strategy


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A ``"fake"`` process group of ``n`` ranks (this process rank 0)
    for the duration; one already started with ``n`` ranks is used as it
    is."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is running; "
                               f"the dry run needs {n}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(tensors: List[torch.Tensor], specs: List[Spec], mesh
            ) -> List[torch.Tensor]:
    from torch.distributed.tensor import distribute_tensor
    return [distribute_tensor(t, mesh, placements(s, mesh),
                              src_data_rank=None)
            for t, s in zip(tensors, specs)]


def _fake_input(spec, device, mode) -> torch.Tensor:
    with mode:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tensors:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               strategy: str = None, seq_shard: bool = False,
               remat_policy=None, accum_steps: int = 1,
               verbose: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Trace one cell's step on the production mesh; returns (the step's
    record as a dict, the cell's meta dict, as the JSON artifact holds
    it).

    ``strategy`` selects the sharding ("tp" / "dp" / "serve", see
    :mod:`repro_torch.distributed.sharding`; None takes the reference's
    default); ``seq_shard`` puts the hidden states' sequence dim on the
    "model" axis; ``remat_policy`` and ``accum_steps`` as
    :func:`make_train_step`'s.  A process group of the mesh's size must
    be running, or none (a fake one is started for the cell).
    """
    cfg = get_config(arch)
    device = trace_device()
    shape = SHAPES[shape_name]
    if shape_name not in cfg.shapes:
        raise ValueError(f"{arch} skips {shape_name}")
    if strategy is None:
        strategy = default_strategy(cfg, shape, multi_pod)
    with fake_world(mesh_size_hint(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        return _trace(cfg, arch, shape_name, shape, mesh, multi_pod,
                      strategy, seq_shard, remat_policy, accum_steps,
                      verbose, device)


def _trace(cfg, arch, shape_name, shape, mesh, multi_pod, strategy,
           seq_shard, remat_policy, accum_steps, verbose, device):
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_dev = mesh.size()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    specs = input_specs(cfg, shape)
    t0 = time.perf_counter()
    params = abstract_params(cfg, device=device, mode=mode)
    pspecs = list(param_specs(params, mesh, strategy).values())
    with mode:
        params = rebuild(params, _placed(leaves(params), pspecs, mesh))
    batch_spec = simple_batch_spec(mesh, shape.global_batch, strategy)
    args: List[torch.Tensor] = list(params.parameters())
    if shape.kind == "train":
        for p in params.parameters():
            p.requires_grad_(True)
        opt = AdamW()
        with mode:
            # the moments take their parameter's placements
            opt_state = opt.init(list(params.parameters()))
            bspecs = data_specs(mesh, shape.global_batch, strategy)
            batch = {k: _placed([_fake_input(v, device, mode)],
                                [bspecs[k]], mesh)[0]
                     for k, v in specs["batch"].items()}
        seq_ax = "model" if (seq_shard and "model" in mesh.mesh_dim_names
                             and "model" not in (batch_spec[0] if
                                                 len(batch_spec) else ()))\
            else None
        act_spec = NamedSharding(mesh, Spec(
            batch_spec[0] if len(batch_spec) else None, seq_ax, None))
        step = make_train_step(cfg, opt, act_spec=act_spec,
                               remat_policy=remat_policy,
                               accum_steps=accum_steps)
        args += leaves(opt_state) + list(batch.values())
        call = lambda: step(params, opt_state, batch)     # noqa: E731
    elif shape.kind == "prefill":
        with mode:
            inputs = _placed([_fake_input(specs["batch"]["inputs"], device,
                                          mode)],
                             [data_specs(mesh, shape.global_batch,
                                         strategy)["inputs"]], mesh)[0]
        step = make_prefill_step(cfg)
        args.append(inputs)
        call = lambda: step(params, {"inputs": inputs})   # noqa: E731
    else:  # decode
        cspecs = cache_specs(cfg, mesh, shape.global_batch)
        caches = abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                 device=device, mode=mode)
        with mode:
            caches = rebuild(caches, _placed(
                leaves(caches), [s for c in cspecs for s in
                                 ((c,) if isinstance(c, Spec) else c)],
                mesh))
            token = _placed([_fake_input(specs["token"], device, mode)],
                            [batch_spec], mesh)[0]
        step = make_serve_step(cfg)
        args += leaves(caches) + [token]
        # the last position of a full context: every cache slot attended
        index = shape.seq_len - 1
        call = lambda: step(params, caches, token, index)  # noqa: E731
    t_setup = time.perf_counter() - t0
    arg_bytes = _local_bytes(args)
    t0 = time.perf_counter()
    with mode, StepRecorder() as rec:
        out = call()
        del out
    t_trace = time.perf_counter() - t0
    record = rec.record
    terms = extract(record, n_dev, model_flops=model_flops_for(cfg, shape),
                    analytic=cell_cost(cfg, shape, remat_policy=remat_policy))
    meta = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod),
        "strategy": strategy, "seq_shard": seq_shard,
        "remat_policy": remat_policy, "accum_steps": accum_steps,
        "device": device, "n_devices": n_dev,
        "setup_s": t_setup, "trace_s": t_trace,
        "memory": {"argument_bytes": arg_bytes,
                   "peak_bytes": arg_bytes + record.peak_new_bytes,
                   "note": "per device, traced on fake tensors (local "
                           "shards), not measured"},
        "counted_flops": record.flops, "counted_bytes": record.bytes,
        "counted_flops_by_op": dict(record.flops_by_op),
        "coll_calls": dict(record.coll_calls),
        **terms.as_dict(),
    }
    if verbose:
        _report(meta, terms)
    return record.__dict__, meta


def _report(meta: dict, terms) -> None:
    analytic = terms.flops
    ratio = meta["counted_flops"] / analytic if analytic else float("nan")
    print(f"== {meta['arch']} x {meta['shape']} x {meta['mesh']} "
          f"({meta['strategy']}, device {meta['device']}) ==")
    print(f"   setup {meta['setup_s']:.1f} s, trace {meta['trace_s']:.1f} s")
    print(f"   flops per device: analytic {analytic:.4e}, counted "
          f"{meta['counted_flops']:.4e} (ratio {ratio:.4f})")
    print("   collective operand bytes per device: " + ", ".join(
        f"{k} {v:.4e} ({meta['coll_calls'][k]} calls)"
        for k, v in meta["coll_bytes"].items()))
    mem = meta["memory"]
    print(f"   bytes per device (traced): arguments "
          f"{mem['argument_bytes']:.4e}, peak {mem['peak_bytes']:.4e}")
    print(f"   roofline on {terms.card.name} rates: compute "
          f"{terms.compute_s * 1e3:.3f} ms, memory "
          f"{terms.memory_s * 1e3:.3f} ms, collective "
          f"{terms.collective_s * 1e3:.3f} ms; dominant {terms.dominant}, "
          f"fraction {terms.roofline_fraction:.4f}")


def run_cells(cells, multi_pod: bool, skip_existing: bool,
              out_dir: Path = None) -> int:
    """Trace ``cells`` ((arch, shape) pairs) on one production mesh under
    one fake group, writing each artifact into ``out_dir`` (``OUT_DIR``
    when None); returns the failures."""
    out_dir = OUT_DIR if out_dir is None else Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    with fake_world(mesh_size_hint(multi_pod)):
        for arch, shape_name in cells:
            out = out_dir / f"{arch}__{shape_name}__{mesh_tag(multi_pod)}" \
                            f".json"
            if skip_existing and out.exists():
                print(f"-- skip existing {out.name}")
                continue
            try:
                _, meta = lower_cell(arch, shape_name, multi_pod=multi_pod)
                out.write_text(json.dumps(meta, indent=1))
            except Exception as e:  # noqa: BLE001 (a cell's failure is
                # reported and counted; the sweep goes on)
                failures += 1
                print(f"!! FAILED {arch} x {shape_name} x "
                      f"{mesh_tag(multi_pod)}: {e}")
                traceback.print_exc()
    return failures


def all_cells():
    cells = []
    for arch, cfg in sorted(all_configs().items()):
        for shape_name in cfg.shapes:
            cells.append((arch, shape_name))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", help="a shape, or several joined by commas")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", help=f"artifact directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, s) for s in args.shape.split(",")]
    else:
        ap.error("--arch with --shape, or --all")
    t0 = time.perf_counter()
    failures = 0
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    for multi_pod in meshes:
        failures += run_cells(cells, multi_pod, args.skip_existing,
                              args.out)
    print(f"dry-run complete: {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
