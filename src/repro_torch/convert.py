"""Carry parameters across from the reference package.

Here the parameters are fitted performance models.  ``repro`` and the port
serialize a :class:`~repro_torch.core.model.ModelSet` in one dict form
(``ModelSet.to_dict()``: a ``"models"`` list of ``PerformanceModel.
to_dict()`` entries — kernel, setup, and per case its pieces' domains and
per-statistic polynomials).  Kernel models, device-suite model sets and
transfer models all use it, so a JSON file written by either package
loads in the other.
"""

from __future__ import annotations

from typing import Mapping

from .core.model import ModelSet


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
