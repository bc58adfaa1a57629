"""repro_torch.store — the persistent platform model store on the card.

The counterpart of ``repro.store``, in three layers:

* :mod:`repro_torch.store.modelstore` — versioned on-disk persistence of
  micro-benchmark measurements and finalized model sets under a
  :mod:`platform fingerprint <repro_torch.store.fingerprint>` of the card
  (its name, compute capability, L2, CUDA runtime and driver);
* :mod:`repro_torch.store.drift` — deterministic re-measurement probes
  that detect when a stored model has drifted off the platform;
* :mod:`repro_torch.store.tournament` — named predictor snapshots scored
  against a measured oracle on the reference's frozen workloads.

``repro_torch.tc`` never imports this package at module level (the
session imports it lazily), so the dependency arrow stays
``store -> tc -> core``.
"""

from .drift import DriftProbe, DriftReading
from .fingerprint import PlatformFingerprint, current_fingerprint
from .modelstore import (DEVICE_MODEL_SET, PARAMETRIC_MODEL_SET,
                         SCHEMA_VERSION, ModelStore, StoreMismatchError)
from .tournament import (Snapshot, SnapshotScore, TournamentResult,
                         Workload, frozen_workloads, kendall_tau,
                         run_tournament, workload)

__all__ = [
    "DEVICE_MODEL_SET", "PARAMETRIC_MODEL_SET", "SCHEMA_VERSION",
    "ModelStore",
    "StoreMismatchError",
    "PlatformFingerprint", "current_fingerprint",
    "DriftProbe", "DriftReading",
    "Snapshot", "SnapshotScore", "TournamentResult", "Workload",
    "frozen_workloads", "kendall_tau", "run_tournament", "workload",
]
