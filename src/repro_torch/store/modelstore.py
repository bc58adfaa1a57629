"""The persistent platform model store (versioned, fingerprint-keyed).

The counterpart of ``repro.store.modelstore``.  A :class:`ModelStore`
makes the paper's "once per platform" amortization real across
processes: it serializes a :class:`~repro_torch.tc.suite.
MicroBenchmarkSuite`'s measurements (keyed by the canonical
:class:`~repro_torch.tc.suite.MicroBenchmarkKey` — equation, kernel
shapes, per-operand cache classes, and for the device sweeps the tile
config), plus any finalized :class:`~repro_torch.core.model.ModelSet`
artifacts, under a :class:`~repro_torch.store.fingerprint.
PlatformFingerprint`.  A later process warm-starts by loading the store
into a fresh suite: every ranking drawn from it re-predicts from the
stored measurements with *zero* new micro-benchmarks, and, because the
measurements round-trip bit-exactly through JSON (``float.__repr__`` is
shortest-round-trip), the predictions are bit-identical to the in-memory
session the store was saved from.

The payload layout is the reference's, so the two packages read each
other's measurement and model-set entries.  Three guards protect the load
path:

* **schema**: a payload whose ``schema_version`` differs from this
  module's :data:`SCHEMA_VERSION` cannot be interpreted by this code and
  refuses outright (``allow_mismatch`` does not override a schema gap);
* **fingerprint**: a payload written on a different platform refuses
  unless ``allow_mismatch=True`` — measurements are facts about a
  platform, not about the code;
* **cache capacity**: on a CUDA platform, a store whose ``cache_bytes``
  is not the running card's L2 refuses unless ``allow_mismatch=True``:
  the warm and cold classes of every stored key were decided against
  that number.

The default ``cache_bytes`` is the L2 of the store's device (0 on the
CPU, where a measuring suite states its own).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

from .._device import DeviceLike, resolve_device
from ..core.contractions import l2_cache_bytes
from ..core.model import ModelSet
from ..core.sampler import Stats
from ..tc.suite import MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite
from .fingerprint import PlatformFingerprint, current_fingerprint

#: store file-format version.  Bump on any payload layout change; the
#: loader refuses mismatched schemas even under ``allow_mismatch=True``.
SCHEMA_VERSION = 1

#: reserved ``model_sets`` name holding fitted size-parametric models
#: (:meth:`repro_torch.tc.parametric.ParametricModels.to_model_set`)
PARAMETRIC_MODEL_SET = "__parametric__"

#: reserved ``model_sets`` name holding fitted *device kernel* models:
#: per-(CUDA kernel, shared-memory class) tile-config polynomials plus the
#: memcpy H2D/D2H transfer models
#: (:meth:`repro_torch.tc.device.DeviceSuite.to_model_set`)
DEVICE_MODEL_SET = "__device__"


class StoreMismatchError(ValueError):
    """A store file refusing to load: wrong schema or wrong platform."""


def _key_to_dict(key: MicroBenchmarkKey) -> dict:
    d = {"equation": key.equation,
         "a_shape": list(key.a_shape),
         "b_shape": list(key.b_shape),
         "out_shape": list(key.out_shape),
         "classes": list(key.classes)}
    if key.config is not None:
        d["config"] = list(key.config)      # device kernel keys only
    return d


def _key_from_dict(d: Mapping) -> MicroBenchmarkKey:
    config = d.get("config")
    return MicroBenchmarkKey(equation=d["equation"],
                             a_shape=tuple(d["a_shape"]),
                             b_shape=tuple(d["b_shape"]),
                             out_shape=tuple(d["out_shape"]),
                             classes=tuple(d["classes"]),
                             config=None if config is None
                             else tuple(config))


def sort_key(key: MicroBenchmarkKey) -> tuple:
    """The canonical deterministic ordering of benchmark keys — used for
    stable payload layout and for the drift probe's subset selection.
    The config facet sorts as ``()`` when absent."""
    return (key.equation, key.a_shape, key.b_shape, key.out_shape,
            key.classes, key.config or ())


def _finite(value: float, what: str) -> float:
    """Stored measurements must be finite: NaN/inf would round-trip into
    silently poisoned rankings."""
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f"non-finite {what} ({value!r}) cannot be stored")
    return value


class ModelStore:
    """Measurements + finalized model artifacts under one fingerprint.

    ``device`` is the platform the store describes: the CUDA card unless
    ``device="cpu"`` (without a card and without that request the
    constructor raises).  The fingerprint defaults to that device's.
    Build one with :meth:`from_suite`, extend it with
    :meth:`add_model_set`, persist with :meth:`save`, and reconstruct with
    :meth:`load`.
    """

    def __init__(self, *,
                 fingerprint: Optional[PlatformFingerprint] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fingerprint = fingerprint if fingerprint is not None \
            else current_fingerprint(device=self.device)
        self.measurements: Dict[MicroBenchmarkKey, MicroBenchmark] = {}
        self.model_sets: Dict[str, ModelSet] = {}
        #: the captured suite's measurement protocol + accumulated cost
        self.suite_meta: Dict[str, float] = {
            "repetitions": 5,
            "cache_bytes": l2_cache_bytes(self.device)
            if self.device.type == "cuda" else 0,
            "seed": 0, "cost_seconds": 0.0}

    # ------------------------------------------------------------ capture --
    @classmethod
    def from_suite(cls, suite: MicroBenchmarkSuite, *,
                   fingerprint: Optional[PlatformFingerprint] = None,
                   device: DeviceLike = None) -> "ModelStore":
        """Capture a suite's measurements (and protocol) into a store."""
        store = cls(fingerprint=fingerprint, device=device)
        store.add_suite(suite)
        return store

    def add_suite(self, suite: MicroBenchmarkSuite) -> None:
        """Merge a suite's measurements into the store.

        The suite's measurement protocol (repetitions, cache capacity,
        seed) becomes the store's — merging suites with conflicting
        protocols raises, since their measurements are not comparable.
        """
        meta = {"repetitions": suite.repetitions,
                "cache_bytes": suite.cache_bytes, "seed": suite.seed}
        for name, value in meta.items():
            if self.measurements and self.suite_meta[name] != value:
                raise ValueError(
                    f"suite {name}={value} conflicts with the store's "
                    f"{name}={self.suite_meta[name]}; one store holds one "
                    f"measurement protocol")
        self.suite_meta.update(meta)
        self.measurements.update(suite.results)
        # total wall-clock behind the stored measurements: what a warm
        # start amortizes
        self.suite_meta["cost_seconds"] = float(
            sum(mb.seconds for mb in self.measurements.values()))

    def add_model_set(self, name: str, models: ModelSet) -> None:
        """Attach a finalized :class:`ModelSet` artifact under ``name``."""
        self.model_sets[name] = models

    def model_set(self, name: str) -> ModelSet:
        return self.model_sets[name]

    def add_parametric_models(self, models) -> None:
        """Attach fitted size-parametric models under
        :data:`PARAMETRIC_MODEL_SET` (a
        :class:`~repro_torch.tc.parametric.ParametricModels` registry or an
        already-exported :class:`ModelSet`)."""
        ms = models.to_model_set() if hasattr(models, "to_model_set") \
            else models
        self.model_sets[PARAMETRIC_MODEL_SET] = ms

    def parametric_model_set(self) -> Optional[ModelSet]:
        """The stored size-parametric models, or ``None``."""
        return self.model_sets.get(PARAMETRIC_MODEL_SET)

    def add_device_models(self, models) -> None:
        """Attach fitted device kernel and transfer models under
        :data:`DEVICE_MODEL_SET` (a :class:`~repro_torch.tc.device.
        DeviceSuite` or an already-exported :class:`ModelSet`).  With
        these stored, a warm-started session ranks tile configs with zero
        fresh device sweeps and no memcpy probe."""
        ms = models.to_model_set() if hasattr(models, "to_model_set") \
            else models
        self.model_sets[DEVICE_MODEL_SET] = ms

    def device_model_set(self) -> Optional[ModelSet]:
        """The stored device kernel + transfer models, or ``None``."""
        return self.model_sets.get(DEVICE_MODEL_SET)

    # ---------------------------------------------------------- warm start --
    def load_into(self, suite: MicroBenchmarkSuite) -> int:
        """Inject every stored measurement into ``suite`` (warm start).

        Keys the suite already measured keep their fresh result.  Loaded
        keys count under the suite's ``loaded`` counter and their original
        wall-clock under ``loaded_cost_seconds``.
        """
        n = 0
        for key, mb in self.measurements.items():
            if key not in suite.results:
                suite.load_measurement(mb)
                n += 1
        return n

    def build_suite(self, *, repetitions: Optional[int] = None,
                    measure_fn=None,
                    device: DeviceLike = None) -> MicroBenchmarkSuite:
        """A fresh suite under the store's measurement protocol, measuring
        on ``device`` (the CUDA card unless ``device="cpu"``), with every
        stored measurement pre-loaded.

        ``repetitions`` may restate the stored value but not contradict
        it; ``measure_fn`` backs any *new* keys and the drift probe.
        """
        stored = int(self.suite_meta["repetitions"])
        if repetitions is not None and repetitions != stored:
            raise ValueError(
                f"repetitions={repetitions} conflicts with the store's "
                f"measurement protocol (repetitions={stored})")
        suite = MicroBenchmarkSuite(
            repetitions=stored,
            cache_bytes=int(self.suite_meta["cache_bytes"]),
            seed=int(self.suite_meta["seed"]),
            measure_fn=measure_fn, device=resolve_device(device))
        self.load_into(suite)
        return suite

    # ------------------------------------------------------------------ io --
    def to_payload(self) -> dict:
        """The JSON payload: schema version first, fingerprint second —
        the two gates the loader checks before touching measurements."""
        return {
            "schema_version": SCHEMA_VERSION,
            "fingerprint": self.fingerprint.as_dict(),
            "suite": dict(self.suite_meta),
            "measurements": [
                {"key": _key_to_dict(key),
                 "stats": {s: _finite(v, f"stat {s}")
                           for s, v in mb.stats.as_dict().items()},
                 "first": _finite(mb.first, "first-call overhead"),
                 "seconds": _finite(mb.seconds, "benchmark cost")}
                for key, mb in sorted(self.measurements.items(),
                                      key=lambda kv: sort_key(kv[0]))],
            "model_sets": {name: ms.to_dict()
                           for name, ms in sorted(self.model_sets.items())},
        }

    def save(self, path: Union[str, Path]) -> None:
        """Write the store to ``path`` (one ``json.dump`` into a freshly
        truncated file)."""
        with open(path, "w") as f:
            json.dump(self.to_payload(), f, indent=1)

    @classmethod
    def load(cls, path: Union[str, Path], *, allow_mismatch: bool = False,
             fingerprint: Optional[PlatformFingerprint] = None,
             device: DeviceLike = None) -> "ModelStore":
        """Load a store, refusing schema, fingerprint and cache-capacity
        mismatches.

        ``device`` is the running platform (the CUDA card unless
        ``device="cpu"``); ``fingerprint`` overrides its fingerprint
        (tests pin it).  ``allow_mismatch=True`` accepts another
        platform's measurements — a *schema* mismatch always refuses.
        """
        dev = resolve_device(device)
        with open(path) as f:
            payload = json.load(f)
        return cls.from_payload(payload, allow_mismatch=allow_mismatch,
                                fingerprint=fingerprint, device=dev,
                                source=str(path))

    @classmethod
    def from_payload(cls, payload: Mapping, *, allow_mismatch: bool = False,
                     fingerprint: Optional[PlatformFingerprint] = None,
                     device: DeviceLike = None,
                     source: str = "payload") -> "ModelStore":
        """:meth:`load` of an already-parsed payload (same gates)."""
        dev = resolve_device(device)
        schema = payload.get("schema_version")
        if schema != SCHEMA_VERSION:
            raise StoreMismatchError(
                f"{source}: store schema_version={schema!r} but this code "
                f"reads schema_version={SCHEMA_VERSION}; re-generate the "
                f"store (allow_mismatch cannot bridge a schema gap)")
        stored_fp = PlatformFingerprint.from_dict(
            payload.get("fingerprint", {}))
        current = fingerprint if fingerprint is not None \
            else current_fingerprint(device=dev)
        if not allow_mismatch:
            mismatched = stored_fp.mismatches(current)
            if mismatched:
                detail = ", ".join(
                    f"{name}: stored={getattr(stored_fp, name)!r} != "
                    f"current={getattr(current, name)!r}"
                    for name in mismatched)
                raise StoreMismatchError(
                    f"{source}: platform fingerprint mismatch ({detail}); "
                    f"pass allow_mismatch=True to load another platform's "
                    f"measurements anyway")
            cache = payload.get("suite", {}).get("cache_bytes")
            if current.backend == "cuda" and \
                    cache != current.l2_cache_bytes:
                raise StoreMismatchError(
                    f"{source}: the store's cache_bytes={cache!r} is not "
                    f"this card's L2 ({current.l2_cache_bytes} bytes); its "
                    f"warm/cold classes were decided against another "
                    f"capacity (allow_mismatch=True loads it anyway)")
        store = cls(fingerprint=stored_fp, device=dev)
        store.suite_meta.update(payload.get("suite", {}))
        for entry in payload.get("measurements", []):
            key = _key_from_dict(entry["key"])
            store.measurements[key] = MicroBenchmark(
                key=key, stats=Stats(**entry["stats"]),
                first=entry["first"], seconds=entry["seconds"])
        for name, ms in payload.get("model_sets", {}).items():
            store.model_sets[name] = ModelSet.from_dict(ms)
        return store

    # ------------------------------------------------------------- summary --
    @property
    def n_keys(self) -> int:
        """Distinct stored micro-benchmark measurements."""
        return len(self.measurements)

    @property
    def cost_seconds(self) -> float:
        """Wall-clock the stored measurements originally cost — what a
        warm start amortizes instead of re-spending."""
        return float(self.suite_meta.get("cost_seconds", 0.0))

    def describe(self) -> str:
        fp = self.fingerprint
        return (f"ModelStore(schema={SCHEMA_VERSION}, keys={self.n_keys}, "
                f"model_sets={len(self.model_sets)}, "
                f"cost={self.cost_seconds:.2f}s, platform={fp.backend}/"
                f"{fp.device_kind}, {fp.cores} cores)")
