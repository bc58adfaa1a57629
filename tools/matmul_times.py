#!/usr/bin/env python3
"""Check and time the tiled matmul by route on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/matmul_times.py [--rounds 3] [--reps 10] [--seed 0]
        [--check-only] [--no-probes] [--checkout DIR]

First the compiler's report for the matmul library (registers and spills
of its wgmma kernels and split pre-pass, ``-Xptxas -v``, and ptxas's
notes that it serialised wgmma products), then the checks:

* chip_smoke's phase 2 matmul checks (``check_matmul_tables`` and
  ``check_kernel_shapes``): the library's route table, staging and scratch
  against ``matmul.py``'s, and every instantiation of both routes in both
  dtypes against ``matmul_plain`` within phase 2's gate, each on its route;
* every wgmma tile at 4096^3 in both dtypes (float32 within 1e-5 max
  |plain|, bfloat16 within phase 2's gate), two calls the same bits.

``--check-only`` stops there.  Then at 4096^3 the times as ``--rounds``
medians of ``--reps`` calls, each between CUDA events: every wgmma tile,
the ffma route's (128, 128, 64) in float32 and (128, 128, 32) in
bfloat16, ``torch.matmul`` (TF32 off) and the plain version; each wgmma
call's kernels from one ``torch.profiler`` window (the float32 split
pre-passes apart).  Unless ``--no-probes``: probes, copies of
``csrc/matmul.cu`` built into ``build/matmul_probe/`` and timed at the
128-row tiles, all nvcc at once: ``no_products`` (the wgmma calls return at
once), ``no_copies`` (the producer hands each stage over uncopied) and
``bare`` (neither).  They compute no product; they say what bounds the
kernel.

``--checkout DIR`` times another checkout's kernels instead (its
``src/``; a checkout without the route table, such as the parent of the
wgmma route, gets the timings at the ffma tiles only): to compare two
checkouts, run the script for each on one card in one command and compare
the times only within that command.  The last line is one JSON object:
the card's name and power limit as ``nvidia-smi`` prints them, the
checkout, the checks and the times in ms.
"""
import argparse
import ctypes
import importlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

N = 4096
GATES = {"float32": 2e-5, "bfloat16": 2e-2}
BIG_TOL = 1e-5
#: the ffma tiles timed beside the wgmma route (the parent's selected
#: float32 tile and a bfloat16 tile the ffma route keeps)
FFMA_TILES = {"float32": (128, 128, 64), "bfloat16": (128, 128, 32)}
#: the 128-row tiles the probes are timed at
PROBE_TILES = {"float32": (128, 128, 32), "bfloat16": (128, 256, 64)}


def median_ms(fn, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of the median device time of ``reps`` calls,
    each between CUDA events, after one call to warm up."""
    import torch
    fn()
    meds = []
    for _ in range(rounds):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        meds.append(statistics.median(s.elapsed_time(e) for s, e in events))
    return statistics.median(meds)


def kernel_means(fn, reps: int) -> dict:
    """{kernel: device ms a launch} of the matmul library's kernels over
    one ``torch.profiler`` window of ``reps`` calls of ``fn`` (each call
    launches each kernel once; the mean is over the launches the window
    kept, since a window may drop its late events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"(matmul_\w+_kernel)", ev.key)
        if m and ev.count:
            total, count = out.get(m.group(1), (0.0, 0))
            out[m.group(1)] = (total + ev.device_time_total,
                               count + ev.count)
    return {k: t / c / 1e3 for k, (t, c) in out.items()}


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call of ``fn`` takes to enqueue its work, over
    ``reps`` calls with no synchronisation between them."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of the
    wgmma kernels and the split pre-pass, and ptxas's serialisation notes,
    from a ``-Xptxas -v`` log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            kern = re.search(r"\d+(matmul_(?:wgmma|split\w*?)_kernel)",
                             name)
            if kern:
                dtype = "bfloat16" if "__nv_bfloat16" in name else "float32"
                ints = ", ".join(re.findall(r"Li(\d+)E", name))
                label = kern.group(1) + (f"<{dtype}, {ints}>" if ints
                                         else "")
                rows.append((label, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    notes = [m.group(1) for m in re.finditer(
        r"(Potential Performance Loss: .*?matmul_wgmma_kernel\S*)", log)]
    return rows, notes


def probes(src: str) -> dict:
    """The probe copies of ``matmul.cu``: {name: source}."""
    def no_products(text):
        for sig in ("void wgmma_bf16_tb(float (&d)[64]",
                    "void wgmma_bf16_tb(float (&d)[128]",
                    "void wgmma_tf32(float (&d)[64], uint64_t da"):
            start = text.index(sig)
            brace = text.index("{", start)
            text = text[:brace + 1] + "\n  return;\n" + text[brace + 1:]
        return text

    def no_copies(text):
        put = "        mbar_expect_tx(full + s, C::kStage);\n"
        assert text.count(put) == 1
        return text.replace(put, "        mbar_arrive(full + s);\n"
                                 "        continue;\n")
    return {"no_products": no_products(src), "no_copies": no_copies(src),
            "bare": no_products(no_copies(src))}


def build_probes(root: Path, srcs: dict) -> dict:
    """Each probe compiled into a shared library, all nvcc at once."""
    from repro_torch.kernels import _build
    out_dir = root / "build" / "matmul_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for name, text in srcs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(csrc), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(so))
        for row in ptxas_report(out)[0]:
            if row[0].startswith("matmul_wgmma_kernel<") and (
                    "128, 128" in row[0] or "128, 256" in row[0]):
                print(f"ptxas ({name}): %s %d registers, spills %d B "
                      f"stored / %d B loaded" % row, flush=True)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path.insert(0, str(root / "src"))
    # chip_smoke's phase 2 checks, from this script's own checkout
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        sys.exit("matmul_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    # the module (the package's ``matmul`` is the wrapper function)
    mm = importlib.import_module("repro_torch.kernels.matmul")
    routed = hasattr(mm, "matmul_route")
    _build.build_all(["matmul"])
    nvcc_s = _build.BUILD_SECONDS.get("matmul")
    print(f"checkout {root}; matmul.cu nvcc {nvcc_s} s", flush=True)
    res = {"checkout": str(root), "nvcc_s": nvcc_s}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if routed:
        log = _build.library_path("matmul").with_suffix(".log").read_text()
        rows, notes = ptxas_report(log)
        for row in rows:
            print("ptxas: %s %d registers, spills %d B stored / %d B loaded"
                  % row, flush=True)
        for note in notes:
            print(f"ptxas: {note}", flush=True)
        res["ptxas"] = rows
        res["serialised"] = notes
        res["tables"] = chip_smoke.check_matmul_tables()
        res["checks"] = chip_smoke.check_kernel_shapes()

    big = {name: (randn(N, N, dtype=dt), randn(N, N, dtype=dt))
           for name, dt in dtypes.items()}
    plains = {}
    if routed:
        wide = []
        for name, dt in dtypes.items():
            x, y = big[name]
            for tile in mm.WGMMA_TILES[dt]:
                key = (name, tile[2])
                if key not in plains:
                    plains[key] = mm.matmul_plain(x, y, bm=N, bn=N,
                                                  bk=tile[2]).float()
                ref = plains[key]
                out = mm.matmul(x, y, bm=tile[0], bn=tile[1], bk=tile[2])
                again = mm.matmul(x, y, bm=tile[0], bn=tile[1], bk=tile[2])
                torch.cuda.synchronize()
                diff = (out.float() - ref).abs()
                if name == "float32":
                    reading = float(diff.max()) / float(ref.abs().max())
                    ok = reading <= BIG_TOL
                else:
                    tol = GATES[name]
                    reading = float((diff / (tol + tol * ref.abs())).max())
                    ok = reading <= 1.0
                same = torch.equal(out, again)
                wide.append({"dtype": name, "tile": list(tile),
                             "max_abs_err": float(diff.max()),
                             "reading": reading, "same_bits": same})
                print(f"4096^3 {name} {tile}: max_abs_err "
                      f"{float(diff.max()):.3e}, reading {reading:.3e}, "
                      f"two calls the same bits: {same}", flush=True)
                if not ok or not same:
                    raise AssertionError(f"4096^3 {name} {tile} failed")
                del out, again
        res["wide"] = wide
    if args.check_only:
        print(json.dumps(res))
        return

    times = {}
    for name, dt in dtypes.items():
        x, y = big[name]
        tiles = list(mm.WGMMA_TILES[dt]) if routed else []
        tiles.append(FFMA_TILES[name])
        if not routed:
            tiles.append((128, 128, 64) if name == "bfloat16"
                         else (128, 128, 32))
        row = {}
        for tile in tiles:
            bm, bn, bk = tile
            if not (mm.tile_legal(N, N, N, *tile, dtype=dt) if routed
                    else mm.tile_legal(N, N, N, *tile)):
                continue
            call = lambda: mm.matmul(x, y, bm=bm, bn=bn, bk=bk)  # noqa
            ms = median_ms(call, args.reps, args.rounds)
            entry = {"ms": ms, "tflops": 2.0 * N ** 3 / ms / 1e9,
                     "route": mm.matmul_route(dt, *tile) if routed
                     else "ffma"}
            if entry["route"] == "wgmma":
                entry["kernels_ms"] = kernel_means(call, args.reps)
                entry["host_ms"] = host_ms(call, args.reps)
            row[f"{bm}x{bn}x{bk}"] = entry
            print(f"{name} {tile} {entry['route']}: {ms:.4f} ms, "
                  f"{entry['tflops']:.1f} TFLOP/s"
                  + (f", kernels {entry['kernels_ms']}, host "
                     f"{entry['host_ms']:.4f} ms a call"
                     if "kernels_ms" in entry else ""), flush=True)
        row["torch.matmul"] = {"ms": median_ms(lambda: torch.matmul(x, y),
                                               args.reps, args.rounds)}
        row["plain"] = {"ms": median_ms(
            lambda: mm.matmul_plain(x, y, bm=128, bn=128,
                                    bk=32 if name == "float32" else 64),
            3, 1)}
        print(f"{name}: torch.matmul {row['torch.matmul']['ms']:.4f} ms, "
              f"plain {row['plain']['ms']:.4f} ms", flush=True)
        times[name] = row
    res["times"] = times

    if routed and not args.no_probes:
        src = (root / "src" / "repro_torch" / "kernels" / "csrc" /
               "matmul.cu").read_text()
        built = _build.load("matmul")
        libs = build_probes(root, probes(src))
        probe = {}
        for vname, lib in libs.items():
            _build._LOADED["matmul"] = lib
            probe[vname] = {}
            for name, tile in PROBE_TILES.items():
                x, y = big[name]
                bm, bn, bk = tile
                call = lambda: mm.matmul(x, y, bm=bm, bn=bn, bk=bk)  # noqa
                ms = median_ms(call, args.reps, args.rounds)
                probe[vname][name] = {"tile": list(tile), "ms": ms,
                                      "kernels_ms": kernel_means(
                                          call, args.reps),
                                      "host_ms": host_ms(call, args.reps)}
                print(f"probe {vname} {name} {tile}: {ms:.4f} ms, "
                      f"kernels {probe[vname][name]['kernels_ms']}, host "
                      f"{probe[vname][name]['host_ms']:.4f} ms a call",
                      flush=True)
        _build._LOADED["matmul"] = built
        res["probes"] = probe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    res["card"] = card
    print(json.dumps(res))


if __name__ == "__main__":
    main()
