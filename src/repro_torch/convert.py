"""Carry parameters across from the reference package.

Most parameters here are fitted performance models.  ``repro`` and the port
serialize a :class:`~repro_torch.core.model.ModelSet` in one dict form
(``ModelSet.to_dict()``: a ``"models"`` list of ``PerformanceModel.
to_dict()`` entries — kernel, setup, and per case its pieces' domains and
per-statistic polynomials).  Kernel models, device-suite model sets and
transfer models all use it, so a JSON file written by either package
loads in the other.

Model weights carry across too: :func:`model_params_from_reference`
builds the port's model (:mod:`repro_torch.models`) from the reference's
``init_params`` tree, its periods unstacked into one module per layer, and
:func:`model_params_to_reference` goes back (for the model's parameters,
or for tensors in their order such as their gradients).

Measurements carry across as well: :func:`suite_from_reference` loads the
reference suite's micro-benchmarks, given as plain records, into the
port's :class:`~repro_torch.tc.suite.MicroBenchmarkSuite`, so both
packages rank from the same measurements; :func:`store_from_reference`
reads a whole saved reference store (``repro.store.ModelStore``) as the
port's :class:`~repro_torch.store.ModelStore`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Mapping, Union

import numpy as np
import torch

from ._device import DeviceLike, resolve_device, to_numpy
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


def store_from_reference(payload_or_path: Union[Mapping, str, Path], *,
                         allow_mismatch: bool = False, fingerprint=None,
                         device: DeviceLike = None):
    """The port's :class:`~repro_torch.store.ModelStore` from a store the
    reference saved (its parsed JSON payload, or the file's path).

    The measurements come across bit-exactly and every model set goes
    through :func:`model_set_from_reference`.  The stored fingerprint is
    kept as it was written: it describes the reference's platform (a JAX
    backend and device kind, ``numpy=…,jax=…``), so the store passes the
    port's gates only with ``allow_mismatch=True``, and a schema gap
    refuses even then.  ``device`` and ``fingerprint`` are those of
    :meth:`~repro_torch.store.ModelStore.load`.
    """
    from .store.modelstore import ModelStore
    if isinstance(payload_or_path, Mapping):
        payload, source = payload_or_path, "reference payload"
    else:
        with open(payload_or_path) as f:
            payload = json.load(f)
        source = str(payload_or_path)
    store = ModelStore.from_payload(
        {**payload, "model_sets": {}}, allow_mismatch=allow_mismatch,
        fingerprint=fingerprint, device=device, source=source)
    for name, ms in payload.get("model_sets", {}).items():
        store.add_model_set(name, model_set_from_reference(ms))
    return store


#: the SSM fields the reference keeps in float32 whatever the model's dtype
_FLOAT32_FIELDS = {"a_log", "d_skip", "dt_bias"}


def model_params_from_reference(cfg, params: Mapping,
                                device: DeviceLike = None, dtype=None):
    """The port's :class:`~repro_torch.models.transformer.Model` holding
    the reference's parameters.

    ``params`` is the reference's ``init_params(cfg, ...)`` tree with numpy
    leaves (``jax.tree_util.tree_map(np.asarray, params)``).  Each block
    leaf's leading ``n_periods`` axis is unstacked: period ``per``'s
    position ``pi`` becomes layer ``per * len(cfg.block_pattern) + pi``.
    ``AttnParams``, ``MambaParams``, ``MoEParams`` and the ``mlp`` dict map
    by field name; ``embed``, ``frontend_proj``, ``head`` and
    ``final_norm`` as they are.  ``dtype`` (a torch dtype) casts every
    leaf but the SSM's ``a_log``, ``d_skip`` and ``dt_bias``, which the
    reference keeps in float32; None keeps each leaf's own type.  The
    model lands on ``device``: the card unless the CPU is asked for.
    """
    from .models.attention import AttnParams
    from .models.mamba import MambaParams
    from .models.moe import MoEParams
    from .models.transformer import Block, Mlp, Model, n_periods
    device = resolve_device(device)

    def tensor(a, name: str = "") -> torch.Tensor:
        t = torch.from_numpy(np.array(a))                # a writable copy
        keep = dtype is None or name in _FLOAT32_FIELDS
        return t.to(device=device, dtype=None if keep else dtype)

    classes = {"attn": AttnParams, "ssm": MambaParams, "moe": MoEParams,
               "mlp": Mlp}
    period = len(cfg.block_pattern)
    blocks = [None] * cfg.n_layers
    for pi, spec in enumerate(cfg.block_pattern):
        tree = params["blocks"][f"p{pi}"]
        for per in range(n_periods(cfg)):
            kw = {}
            for group, leaf in tree.items():
                if group in classes:
                    fields = leaf._asdict() if hasattr(leaf, "_asdict") \
                        else leaf                      # the mlp dict
                    kw[group] = classes[group](**{
                        name: tensor(a[per], name)
                        for name, a in fields.items()})
                else:                                  # ln1, ln2
                    kw[group] = tensor(leaf[per])
            blocks[per * period + pi] = Block(spec, **kw)
    top = {name: tensor(params[name])
           for name in ("embed", "frontend_proj", "head") if name in params}
    return Model(blocks, tensor(params["final_norm"]), period=period, **top)


def model_params_to_reference(cfg, model, tensors=None) -> dict:
    """The reference's ``init_params`` tree with numpy leaves from the
    port's model: the inverse of :func:`model_params_from_reference`.

    Each layer's leaves are stacked back over a leading ``n_periods``
    axis; ``embed``, ``frontend_proj``, ``head`` and ``final_norm`` come
    as they are.  The reference's ``AttnParams``, ``MambaParams`` and
    ``MoEParams`` come as dicts keyed by their field names (``mlp`` is a
    dict there too).  ``tensors``, in ``model.named_parameters()`` order,
    are converted in the parameters' place (their gradients, for
    instance).  bfloat16 leaves widen to float32, exactly.
    """
    from .models.transformer import n_periods
    named = list(model.named_parameters())
    values = dict(zip((n for n, _ in named),
                      (p for _, p in named) if tensors is None else tensors))
    if len(values) != len(named):
        raise ValueError(f"{len(named)} parameters, {len(values)} tensors")
    period, nper = len(cfg.block_pattern), n_periods(cfg)

    def stacked(pi: int, suffix: str) -> np.ndarray:
        return np.stack([to_numpy(values[f"blocks.{per * period + pi}."
                                         f"{suffix}"])
                         for per in range(nper)])

    out = {name: to_numpy(values[name])
           for name in ("embed", "frontend_proj", "head", "final_norm")
           if name in values}
    out["blocks"] = {}
    for pi in range(period):
        first, tree = model.blocks[pi], {}
        for group in ("ln1", "ln2"):
            if getattr(first, group) is not None:
                tree[group] = stacked(pi, group)
        for group in ("attn", "ssm", "mlp", "moe"):
            mod = getattr(first, group)
            if mod is not None:
                tree[group] = {field: stacked(pi, f"{group}.{field}")
                               for field, _ in mod.named_parameters()}
        out["blocks"][f"p{pi}"] = tree
    return out
