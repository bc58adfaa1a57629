#!/usr/bin/env python3
"""Where the Mamba-2 mixer's two backward kernels spend their time on a
CUDA card: the kernels as built, and copies of ``csrc/mamba_mixer.cu``
with one part taken out.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/mixer_bwd_probe.py [--reps 20] [--seed 0] [--checkout DIR]
        [--dump FILE] [--compare FILE]

Libraries built from the checkout's ``csrc/mamba_mixer.cu`` with the flags
of ``kernels/_build.py`` into ``build/mixer_bwd_probe/``, all at once:

* ``as_built``: the source unchanged;
* ``no_sum``: a constant in place of ``mamba_out_bwd``'s row sum (its
  block-wide reduction and the dot behind it);
* ``no_reload``: ``mamba_out_bwd``'s second pass takes x and z from the
  first pass's registers instead of reading them again (from global
  memory in a kernel that rereads them; a kernel that stages its rows in
  shared memory rereads them there, and has no such variant);
* ``no_colsum``: no column sums (norm_g's and d_skip's gradients);
* ``loads_only``: every 16-byte store to global memory skipped (its
  values still computed, as the skip tests them);
* ``stores_only``: every 16-byte load from global memory replaced by
  values made from its address (a kernel that stages its rows fills
  each shared-memory slot with a constant instead).

Only ``as_built`` computes the gradients; the others exist to be timed.
Each library's ``mamba_out_bwd`` and ``mamba_in_bwd`` are timed at
mamba2-2.7b's (1, 4096, 80, 64, 1, 128) and jamba-v0.1-52b's (1, 4096,
128, 64, 1, 16) widths in bfloat16 and float32, in one ``torch.profiler``
window of ``--reps`` calls each (each kernel's device time a call; the
finishes apart).  ``as_built`` is first held to the bits of the library
the wrapper builds.  Each kernel's registers come from ptxas, its blocks
per SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the
launch the wrapper makes.  ``--dump`` saves each case's gradients;
``--compare`` holds them against another checkout's dump on the same
inputs (dy's and the gradient buffer's bits, the parameter gradients'
normwise difference).  The last line is one JSON object: the card's name
and power limit as ``nvidia-smi`` prints them, the times in ms, the
registers, the occupancy and the comparison.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

CASES = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128),
         "jamba-v0.1-52b": (1, 4096, 128, 64, 1, 16)}
#: each kernel's vector-path entry function as its mangled name holds it:
#: a source whose mamba_out_bwd stages its rows ahead in shared memory
#: ("staged"), or one whose mamba_out_bwd reads each row as it comes
#: ("rows", the older design, for --checkout of an older tree)
ENTRIES = {"staged": {"out": "mamba_out_bwd_vec_kernel",
                      "in": "mamba_in_bwd_vec_kernel"},
           "rows": {"out": "mamba_out_bwd_kernel",
                    "in": "mamba_in_bwd_kernel"}}


def after_brace(src: str, marker: str, text: str) -> str:
    """``src`` with ``text`` first in the body that follows ``marker`` (a
    function's signature, which must occur once)."""
    assert src.count(marker) == 1, marker
    brace = src.index("{", src.index(marker))
    return src[:brace + 1] + "\n" + text + src[brace + 1:]


def replace_once(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def loads_only(src: str) -> str:
    """Each 16-byte store helper returns before it stores unless its
    values add up to 3e38, which the inputs never give (the test reads
    every value, so no load is dropped)."""
    test = ("  float t = v[0];\n  for (int i = 1; i < kChunk; ++i) t += v[i];"
            "\n  if (t != 3.0e38f) return;")
    sigs = ["void store8(float* p,", "void store8(__nv_bfloat16* p,"]
    if "void store4(" in src:
        sigs += ["void store4(float* p,", "void store4(__nv_bfloat16* p,"]
    for sig in sigs:
        src = after_brace(src, sig, test.replace("kChunk", str(
            4 if "store4" in sig else 8)))
    return src


def stores_only(src: str, layout: str) -> str:
    """Each 16-byte load helper gives values made from its address; a
    staging copy writes a constant into its slot instead."""
    fake = ("  const float s = static_cast<float>((reinterpret_cast<"
            "uintptr_t>(p) >> 4) & 15);\n  for (int i = 0; i < kChunk; ++i) "
            "v[i] = s + 0.125f * i;\n  return;")
    sigs = ["void load8(const float* p,",
            "void load8(const __nv_bfloat16* p,"]
    if "void load4(" in src:
        sigs += ["void load4(const float* p,",
                 "void load4(const __nv_bfloat16* p,"]
    for sig in sigs:
        src = after_brace(src, sig, fake.replace("kChunk", str(
            4 if "load4" in sig else 8)))
    if layout == "staged":
        src = after_brace(src, "void cp_async16(", "  *static_cast<uint4*>("
                          "smem) = make_uint4(0x3f803f80u, 0x3f803f80u, "
                          "0x3f803f80u, 0x3f803f80u);\n  return;")
    return src


def variants(src: str, layout: str) -> dict:
    """Every variant's source (the ones that apply to this layout)."""
    out = {"as_built": src, "loads_only": loads_only(src),
           "stores_only": stores_only(src, layout)}
    if layout == "rows":
        out["no_sum"] = replace_once(
            src, "const float dr = block_sum(dot, red);",
            "const float dr = 0.5f;")
        keep = replace_once(
            src, "float yt[kSteps][kN], sg[kSteps][kN], dof[kSteps][kN];",
            "float yt[kSteps][kN], sg[kSteps][kN], dof[kSteps][kN], "
            "xk[kSteps][kN], zk[kSteps][kN];")
        keep = replace_once(
            keep, "                   sg[k], xv, zv);\n",
            "                   sg[k], xv, zv);\n      for (int e = 0; e < kN;"
            " ++e) xk[k][e] = xv[e], zk[k][e] = zv[e];\n")
        out["no_reload"] = replace_once(
            keep, "        load8(zrow + di + col, xv);\n"
            "        load8(zrow + col, zv);\n",
            "        for (int e = 0; e < kN; ++e) xv[e] = xk[k][e], zv[e] = "
            "zk[k][e];\n")
        out["no_colsum"] = replace_once(
            src, "        acc_g[col + e] = __fadd_rn(acc_g[col + e],\n"
            "                                   __fmul_rn(dof[k][e], "
            "__fmul_rn(u, r)));\n        acc_s[col + e] = __fadd_rn(acc_s["
            "col + e], __fmul_rn(dyo[e], xv[e]));\n", "")
    else:
        out["no_sum"] = replace_once(
            src, "const float dr = row_sum(dot, red[k & 1]);",
            "const float dr = 0.5f;")
        out["no_colsum"] = replace_once(
            src, "          acc_g[c] = __fadd_rn(acc_g[c], __fmul_rn(dof[e], "
            "__fmul_rn(u, r)));\n          acc_s = __fadd_rn(acc_s, "
            "__fmul_rn(dyo[e], xv[e]));\n", "")
    return out


#: appended to each copy: blocks per SM of the vector-path kernels at the
#: launch the wrapper makes (threads, dynamic shared memory) -- the
#: library's own entry where the source has one
SHIM = {"rows": """
extern "C" int probe_occupancy(int which, int dtype, int di, int h,
                               int* out) {
  (void)h;
  const int threads = which == 0 ? row_threads(di) : kRowThreads;
  const size_t smem = which == 0 ? 2 * sizeof(float) * di : 0;
  const void* fn = which == 0
      ? (dtype ? (const void*)mamba_out_bwd_kernel<__nv_bfloat16, true>
               : (const void*)mamba_out_bwd_kernel<float, true>)
      : (dtype ? (const void*)mamba_in_bwd_kernel<__nv_bfloat16, true>
               : (const void*)mamba_in_bwd_kernel<float, true>);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  out[1] = threads, out[2] = static_cast<int>(smem), out[3] = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, threads, smem));
}
""", "staged": """
extern "C" int probe_occupancy(int which, int dtype, int di, int h,
                               int* out) {
  (void)h;
  return repro_mamba_bwd_occupancy(which, dtype, di, out);
}
"""}


def build(srcs: dict, layout: str, out_dir: Path, csrc: Path) -> dict:
    """Each source compiled into a shared library, all nvcc at once:
    {name: (library, ptxas log)}."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text + SHIM[layout])
        so = out_dir / f"{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = (ctypes.CDLL(str(so)), log)
    return libs


def registers(log: str, layout: str) -> dict:
    """ptxas's (registers, spill stores, spill loads) of each vector-path
    kernel, by its template arguments as the mangled name holds them."""
    import chip_smoke
    out = {}
    for which, entry in ENTRIES[layout].items():
        for name, row in chip_smoke.ptxas_entries(log).items():
            m = re.search(r"\d+" + entry + r"I(.*?)E(?=Ev)", name)
            if m and (layout == "staged" or "Lb1E" in name):
                out.setdefault(which, {})[m.group(1)] = row
    return out


def occupancy(lib, which: int, dtype_code: int, di: int, h: int) -> dict:
    buf = (ctypes.c_int * 4)()
    fn = lib.probe_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(which, dtype_code, di, h, ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"occupancy query failed (cudaError {err})")
    return {"blocks_per_sm": buf[0], "threads": buf[1],
            "smem_bytes": buf[2], "stages": buf[3]}


#: the gradients a case's calls return, in order
OUTPUTS = ("dy", "d_norm_g", "d_skip", "d_dt_bias", "grad")


def compare(mine: dict, theirs: dict) -> dict:
    """Each case's gradients against another checkout's on the same inputs
    (the same seed): whether dy and zxbcdt's gradient buffer have the same
    bits, and the parameter gradients' normwise difference."""
    import torch
    out = {}
    for key, tensors in mine.items():
        row = {}
        for name, a, b in zip(OUTPUTS, tensors, theirs[key]):
            if name in ("dy", "grad"):
                row[name + "_same_bits"] = bool(torch.equal(a, b))
            else:
                a, b = a.double(), b.double()
                row[name + "_normwise"] = float(
                    torch.linalg.norm(a - b) / torch.linalg.norm(b))
        out[key] = row
        print(f"{key} against {len(theirs)} cases: {row}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--dump", type=Path,
                    help="save each case's gradients (torch.save) here")
    ap.add_argument("--compare", type=Path,
                    help="a --dump of another checkout to hold these "
                         "gradients against")
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("mixer_bwd_probe: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_mixer as mm
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "mamba_mixer.cu").read_text()
    layout = "staged" if ENTRIES["staged"]["out"] in src else "rows"
    _build.build_all(["mamba_mixer"])
    wrapper_lib = _build.load("mamba_mixer")
    libs = build(variants(src, layout), layout,
                 root / "build" / "mixer_bwd_probe", csrc)
    regs = {name: registers(log, layout) for name, (_, log) in libs.items()}
    print(f"layout {layout}; registers (as_built): {regs['as_built']}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res, occ, got_bits = {}, {}, {}
    for case, (b, s, h, p, g, n) in CASES.items():
        di = h * p
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{case} {str(dtype).split('.')[-1]}"
            code = int(dtype == torch.bfloat16)
            occ[key] = {k: occupancy(libs["as_built"][0], i, code, di, h)
                        for i, k in enumerate(("mamba_out_bwd",
                                               "mamba_in_bwd"))}
            print(f"{key} occupancy: {occ[key]}", flush=True)

            def rand(*sh, scale=1.0):
                return torch.randn(sh, generator=gen, device="cuda") * scale

            zx = rand(b, s, 2 * di + 2 * g * n + h).to(dtype)
            d_skip, dt_bias = 1 + rand(h, scale=0.3), rand(h, scale=0.5) - 1
            norm_g = rand(di, scale=0.2).to(dtype)
            y, d_out = rand(b, s, h, p), rand(b, s, di).to(dtype)
            dx, ddt = rand(b, s, h, p), rand(b, s, h)
            db, dc = rand(b, s, g, n), rand(b, s, g, n)
            _build._LOADED["mamba_mixer"] = wrapper_lib
            _, r = mm.mamba_out(y, zx, d_skip, norm_g)
            grad = torch.empty_like(zx)

            def calls():
                dy = mm.mamba_out_bwd(d_out, y, zx, r, d_skip, norm_g,
                                      grad)
                return (*dy, mm.mamba_in_bwd(dx, db, dc, ddt, dy[0], zx,
                                             dt_bias, d_skip, grad), grad)

            want = [t.clone() for t in calls()]
            got_bits[key] = [t.cpu() for t in want]
            res[key] = {}
            for name, (lib, _) in libs.items():
                _build._LOADED["mamba_mixer"] = lib
                got = calls()
                torch.cuda.synchronize()
                if name == "as_built" and not all(
                        torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"{key}: as_built differs from the "
                                         f"wrapper's bits")
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        calls()
                    torch.cuda.synchronize()
                ms = {}
                for ev in prof.key_averages():
                    m = re.search(r"(mamba_(?:out|in)_bwd_\w*?kernel)",
                                  ev.key)
                    if m and ev.count:
                        ms[m.group(1)] = ms.get(m.group(1), 0.0) + \
                            ev.device_time_total / args.reps / 1e3
                res[key][name] = ms
                print(f"{key} {name}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(ms.items())),
                    flush=True)
            _build._LOADED["mamba_mixer"] = wrapper_lib
            del zx, y, d_out, dx, ddt, db, dc, grad, want, r
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.dump:
        torch.save(got_bits, args.dump)
    against = compare(got_bits, torch.load(args.compare)) if args.compare \
        else None
    print(json.dumps({"card": card, "checkout": str(root), "layout": layout,
                      "against": against,
                      "ms": res, "registers": regs, "occupancy": occ}))


if __name__ == "__main__":
    main()
