"""Carry parameters across from the reference package.

Here the parameters are fitted performance models.  ``repro`` and the port
serialize a :class:`~repro_torch.core.model.ModelSet` in one dict form
(``ModelSet.to_dict()``: a ``"models"`` list of ``PerformanceModel.
to_dict()`` entries — kernel, setup, and per case its pieces' domains and
per-statistic polynomials).  Kernel models, device-suite model sets and
transfer models all use it, so a JSON file written by either package
loads in the other.

Measurements carry across too: :func:`suite_from_reference` loads the
reference suite's micro-benchmarks, given as plain records, into the
port's :class:`~repro_torch.tc.suite.MicroBenchmarkSuite`, so both
packages rank from the same measurements.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from .core.model import ModelSet
from .core.sampler import Stats
from .tc.suite import MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite


def model_set_from_reference(dicts: Mapping) -> ModelSet:
    """The port's :class:`ModelSet` from a reference ``ModelSet.to_dict()``
    (or the parsed JSON of a saved reference model set)."""
    if "models" not in dicts:
        raise ValueError("not a ModelSet dict: no 'models' entry")
    for entry in dicts["models"]:
        missing = {"kernel", "cases"} - set(entry)
        if missing:
            raise ValueError(f"model entry lacks {sorted(missing)}")
    return ModelSet.from_dict(dicts)


def suite_from_reference(records: Iterable[Mapping],
                         **suite_kwargs) -> MicroBenchmarkSuite:
    """The port's suite holding the reference's measurements.

    Each record is one reference ``MicroBenchmark`` as plain data:
    ``{"key": {"equation", "a_shape", "b_shape", "out_shape", "classes",
    "config"}, "stats": {"min", "med", "max", "mean", "std"}, "first":
    s, "seconds": s}``.  Each goes in through
    :meth:`~repro_torch.tc.suite.MicroBenchmarkSuite.load_measurement`,
    so it counts as loaded, not measured.  ``suite_kwargs`` build the
    suite (``repetitions=``, ``cache_bytes=``, ``measure_fn=``,
    ``device=``, ...).
    """
    suite = MicroBenchmarkSuite(**suite_kwargs)
    for rec in records:
        k = rec["key"]
        config = k.get("config")
        key = MicroBenchmarkKey(
            equation=k["equation"], a_shape=tuple(k["a_shape"]),
            b_shape=tuple(k["b_shape"]), out_shape=tuple(k["out_shape"]),
            classes=tuple(k["classes"]),
            config=tuple(config) if config is not None else None)
        suite.load_measurement(MicroBenchmark(
            key=key, stats=Stats(**rec["stats"]), first=rec["first"],
            seconds=rec["seconds"]))
    return suite
