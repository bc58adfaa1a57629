"""Platform fingerprints: what a stored model is a model *of*.

The counterpart of ``repro.store.fingerprint``.  The paper's amortization
argument — models are "generated automatically once per platform"
(Ch. 4) — holds only while *platform* means the same thing across
processes.  A :class:`PlatformFingerprint` pins down the identity a
:class:`~repro_torch.store.modelstore.ModelStore` file is valid for: the
host CPU and core count, the device the measurements ran on (its name,
compute capability and L2 size), the CUDA runtime and driver, the library
versions the measurements went through, the measurement dtype, and the
package version that produced the artifact.  Loading a store whose
fingerprint differs from the running platform's refuses by default
(``allow_mismatch=True`` opts into reuse).

The reference's fingerprint describes a JAX platform (backend and device
kind as jax reports them, ``numpy=…,jax=…``).  Here the same fields
describe the card: ``backend`` is ``"cuda"`` or ``"cpu"``,
``device_kind`` is ``torch.cuda.get_device_name`` and ``libraries`` is
``numpy=…,torch=…``; four fields are added.  A payload written by the
reference lacks them, and a missing field reads ``"missing"``, so such a
store is refused on its fingerprint.

The file-format *schema* version is not a fingerprint field: the store
loader checks it first and separately (``SCHEMA_VERSION`` in
:mod:`repro_torch.store.modelstore`).
"""

from __future__ import annotations

import ctypes
import os
import platform
from dataclasses import asdict, dataclass, fields
from importlib.metadata import PackageNotFoundError, version
from typing import Dict, List

import torch

from .._device import DeviceLike, resolve_device
from ..core.contractions import l2_cache_bytes

#: package version when importlib metadata is unavailable (running from a
#: source tree via PYTHONPATH, not an installed wheel)
_FALLBACK_VERSION = "0.1.0"
#: the distribution both packages ship in (``pyproject.toml``)
_DISTRIBUTION = "repro-dla-perfmodel"


def package_version() -> str:
    """The package version stamped into every store artifact."""
    try:
        return version(_DISTRIBUTION)
    except PackageNotFoundError:
        return _FALLBACK_VERSION


def _cpu_model() -> str:
    """A best-effort CPU model string."""
    model = platform.processor() or platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return model


def _library_versions() -> str:
    """The measurement-relevant library stack, one canonical string."""
    import numpy as np
    return f"numpy={np.__version__},torch={torch.__version__}"


def _driver_version() -> str:
    """The CUDA driver's version as the driver reports it
    (``cuDriverGetVersion``: 1000 major + 10 minor, e.g. ``12040``)."""
    get_version = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion
    get_version.argtypes = [ctypes.POINTER(ctypes.c_int)]
    get_version.restype = ctypes.c_int
    value = ctypes.c_int()
    rc = get_version(ctypes.byref(value))
    if rc != 0:
        raise RuntimeError(f"cuDriverGetVersion failed with CUDA error {rc}")
    return str(value.value)


@dataclass(frozen=True)
class PlatformFingerprint:
    """The platform identity a stored suite or model is valid for."""

    cpu: str                 # host CPU model string
    cores: int               # logical core count
    backend: str             # "cuda" or "cpu": where the measurements ran
    device_kind: str         # torch.cuda.get_device_name, or "cpu"
    compute_capability: str  # "9.0" on the H100, "none" on the CPU
    cuda_runtime: str        # torch.version.cuda, "none" on the CPU
    driver_version: str      # cuDriverGetVersion, "none" on the CPU
    l2_cache_bytes: int      # the card's L2 (0 on the CPU)
    libraries: str           # "numpy=...,torch=..." measurement stack
    dtype: str               # operand dtype the micro-benchmarks run in
    repro_version: str       # package version that wrote the store

    def as_dict(self) -> Dict[str, object]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "PlatformFingerprint":
        names = [f.name for f in fields(PlatformFingerprint)]
        return PlatformFingerprint(**{n: d.get(n, "missing") for n in names})

    def mismatches(self, other: "PlatformFingerprint") -> List[str]:
        """Field names on which the two fingerprints disagree."""
        return [f.name for f in fields(self)
                if getattr(self, f.name) != getattr(other, f.name)]


def current_fingerprint(*, dtype: str = "float32",
                        device: DeviceLike = None) -> PlatformFingerprint:
    """The running process's platform fingerprint on ``device`` (the CUDA
    card unless ``device="cpu"``; without a card that request raises).

    ``dtype`` names the operand dtype of the stored measurements: the
    contraction micro-benchmarks and the device sweeps run in float32.
    On the CPU the device fields say so and the L2 reads 0.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        device_fields = dict(
            backend="cuda", device_kind=torch.cuda.get_device_name(dev),
            compute_capability=f"{major}.{minor}",
            cuda_runtime=str(torch.version.cuda),
            driver_version=_driver_version(),
            l2_cache_bytes=l2_cache_bytes(dev))
    else:
        device_fields = dict(
            backend="cpu", device_kind="cpu", compute_capability="none",
            cuda_runtime="none", driver_version="none", l2_cache_bytes=0)
    return PlatformFingerprint(
        cpu=_cpu_model(), cores=os.cpu_count() or 1,
        libraries=_library_versions(), dtype=dtype,
        repro_version=package_version(), **device_fields)
