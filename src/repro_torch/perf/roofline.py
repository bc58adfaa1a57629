"""Peak rates of the cards the port runs on, keyed by device name, and
the roofline terms of a step.

The counterpart of ``repro/perf/roofline.py``.  The reference's
constants are a TPU's; here every rate is a card's published figure
(NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at its
full 700 W power limit, NVLink 450 GB/s each way); a card set below that
limit runs slower under load, so measured shares are stated beside the
card's power limit.  The names are what ``torch.cuda.get_device_name()``
returns.

:class:`RooflineTerms` takes its peak, memory and interconnect rates from
a :class:`Card` (the H100 SXM's unless another is given): compute term =
FLOPs / the card's bf16 tensor peak, memory term = bytes / its HBM rate,
collective term = collective operand bytes / its link rate.
:func:`collective_bytes` parses compiled HLO text, as the reference's
does, and :func:`model_flops_for` counts 6 N D.

PyTorch has no compiled executable to read, so :func:`extract` takes the
record of one traced step (:class:`StepRecorder`, a dispatch mode over a
step run on fake tensors): the FLOPs that ``FlopCounterMode``'s formulas
give for every local operation (the kernels' operators included), the
bytes each non-view operation reads and writes, and the collectives'
operand bytes by kind, on the reference's convention (all-gather operand
= result / g, reduce-scatter operand = result x g).  ``DTensor``
operations are left to ``DTensor``, so the record holds what one rank's
shards compute and send.
"""

from __future__ import annotations

import re
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@dataclass(frozen=True)
class Card:
    """Published peak rates and sizes of one card."""

    name: str
    fp32_flops: float        # FLOP/s, float32 outside the tensor cores
    bf16_tensor_flops: float  # FLOP/s, dense bfloat16 on the tensor cores
    tf32_tensor_flops: float  # FLOP/s, dense TF32 on the tensor cores
    hbm_bytes_per_s: float   # device-memory bandwidth
    sms: int                 # streaming multiprocessors
    power_w: float           # the power limit the rates assume
    link_bytes_per_s: float = 0.0  # interconnect to another card, each way


#: the H100 SXM (80 GB HBM3), the card the port is written for
H100_SXM = Card(name="NVIDIA H100 80GB HBM3", fp32_flops=67e12,
                bf16_tensor_flops=989e12, tf32_tensor_flops=495e12,
                hbm_bytes_per_s=3.35e12, sms=132,
                power_w=700.0, link_bytes_per_s=450e9)

CARDS: Dict[str, Card] = {c.name: c for c in (H100_SXM,)}


def card(name: str) -> Card:
    """The constants of the card ``torch.cuda.get_device_name()`` names;
    raises ``KeyError`` for a card whose figures are not recorded here
    (no silent substitution of another card's peaks)."""
    try:
        return CARDS[name]
    except KeyError:
        raise KeyError(f"no published constants recorded for {name!r}; "
                       f"known cards: {sorted(CARDS)}") from None


def card_of(device: torch.device) -> Card:
    """The constants of ``device``'s card: a CUDA device is looked up by
    ``torch.cuda.get_device_name``; the CPU, which has no card, ranks
    with the H100 SXM's (the card the port is written for)."""
    if device.type == "cuda":
        return card(torch.cuda.get_device_name(device))
    return H100_SXM


def peak_flops(the_card: Card, dtype: torch.dtype) -> float:
    """The card's peak rate for operands of ``dtype``: the dense bfloat16
    tensor-core rate for bfloat16 (the least time any bfloat16 kernel
    could take), the FP32 non-tensor rate for float32 (kept IEEE, no
    TF32)."""
    if dtype == torch.bfloat16:
        return the_card.bf16_tensor_flops
    if dtype == torch.float32:
        return the_card.fp32_flops
    raise ValueError(f"no peak rate recorded for {dtype}")


# ------------------------------------------------------------ HLO text --

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# post-optimization HLO prints operands as bare names, so operand bytes are
# derived from the RESULT shape + the replica-group size g:
#   all-reduce:          operand = result
#   all-gather:          operand = result / g   (result is the gathered full)
#   reduce-scatter:      operand = result * g   (result is the reduced shard)
#   all-to-all / c-perm: operand = result
_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[([0-9,]+)\]<=\[")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _result_bytes(result: str) -> int:
    total = 0
    for sm in _SHAPE_RE.finditer(result):
        if sm.group(1) in _DTYPE_BYTES:
            total += _shape_bytes(sm.group(1), sm.group(2))
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        ids = [x for x in m.group(1).replace(" ", "").split(",") if x]
        return max(1, len(ids))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        dims = [int(x) for x in m.group(1).split(",")]
        return max(1, dims[-1])
    return 1


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum operand bytes per collective kind over the per-device module.

    Async ``-start`` forms are counted; their ``-done`` halves are not
    (no double counting).
    """
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        result, kind = m.group(1), m.group(2)
        rb = _result_bytes(result)
        g = _group_size(line)
        if kind == "all-gather":
            rb = rb // max(g, 1)
        elif kind == "reduce-scatter":
            rb = rb * g
        out[kind] += rb
    return out


# ------------------------------------------------------ roofline terms --

@dataclass
class RooflineTerms:
    """The three roofline terms of one step on ``card``'s rates: the
    reference's class with its TPU constants replaced by a :class:`Card`
    (the H100 SXM's by default); the arithmetic is the reference's."""

    flops: float                     # per-device FLOPs (analytic if avail.)
    bytes_accessed: float            # per-device HBM bytes
    coll_bytes: Dict[str, int]      # per-device collective operand bytes
    n_devices: int
    model_flops: float = 0.0         # 6*N*D (global, useful FLOPs)
    hlo_flops: float = 0.0           # raw cost_analysis value (body-once)
    hlo_bytes: float = 0.0
    card: Card = H100_SXM            # peak, memory and link rates

    @property
    def coll_total(self) -> int:
        return sum(self.coll_bytes.values())

    @property
    def compute_s(self) -> float:
        return self.flops / self.card.bf16_tensor_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.card.hbm_bytes_per_s

    @property
    def collective_s(self) -> float:
        return self.coll_total / self.card.link_bytes_per_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global FLOPs): remat/redundancy waste."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute seconds / bound seconds (the score per cell)."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops / self.n_devices / \
            self.card.bf16_tensor_flops
        return useful_s / self.bound_s

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": dict(self.coll_bytes),
            "coll_total": self.coll_total, "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --------------------------------------------------- traced-step record --

#: the functional collectives ``DTensor`` issues, by the reference's kinds
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(x) -> int:
    """Bytes of a tensor, or of the tensors of a list or tuple."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _in_shape_inference() -> bool:
    """Whether ``DTensor``'s output-shape inference is on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        frame = frame.f_back
    return False


@dataclass
class StepRecord:
    """What one rank's traced step did: FLOPs, bytes read and written,
    collective operand bytes by kind, peak bytes of the tensors it made
    (live at once)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    coll_calls: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    peak_new_bytes: int = 0
    flops_by_op: Dict[str, float] = field(default_factory=dict)


class StepRecorder(TorchDispatchMode):
    """Records a step into :attr:`record` (a :class:`StepRecord`).

    Operations on ``DTensor``s are handed back to ``DTensor``
    (``NotImplemented``), which runs them as local operations and
    functional collectives that this mode then sees: so every count is
    one rank's.  FLOPs come from ``torch.utils.flop_counter``'s formulas
    (``FlopCounterMode``'s registry, the kernels' operators included);
    bytes are each non-view operation's tensor operands and outputs,
    each once; a collective's operand bytes are its input's (all-gather:
    result / g; reduce-scatter: result x g, as the reference counts);
    live bytes follow the storages the step creates, each counted until
    it is freed.  ``DTensor`` infers its outputs' shapes by running each
    new operation once on fake tensors of the global shapes (in
    ``ShardingPropagator._propagate_tensor_meta_non_cached``): those runs
    are not the step's work and are not recorded.
    """

    def __init__(self):
        super().__init__()
        self.record = StepRecord()
        self._live = 0
        self._seen: Dict[int, int] = {}

    def _track(self, out) -> None:
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self._live += st.nbytes()
            self.record.peak_new_bytes = max(self.record.peak_new_bytes,
                                             self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_shape_inference():
            return out
        packet = func._overloadpacket
        rec = self.record
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            rec.flops += n
            name = str(packet)
            rec.flops_by_op[name] = rec.flops_by_op.get(name, 0) + n
        kind = _FUNCOL_KINDS.get(packet.__name__) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            rec.coll_bytes[kind] += _nbytes(args[0])
            rec.coll_calls[kind] += 1
        if not func.is_view:
            rec.bytes += _nbytes(list(args)) + _nbytes(
                list(kwargs.values())) + _nbytes(out)
            if not func._schema.is_mutable:   # in place: no new storage
                self._track(out)
        return out


def extract(record: StepRecord, n_devices: int, model_flops: float = 0.0,
            analytic=None, card: Card = H100_SXM) -> RooflineTerms:
    """:class:`RooflineTerms` of one traced step on ``card``'s rates, as
    the reference's ``extract`` builds them from a compiled executable:
    ``record.flops`` and ``record.bytes`` stand for its ``cost_analysis``
    (``hlo_flops``, ``hlo_bytes``; per device, as the record is one
    rank's), the record's collective bytes for its parsed HLO.  With
    ``analytic`` (a ``perf.analytic.CellCost``, GLOBAL counts) flops and
    bytes are ``analytic.flops / n_devices`` and ``analytic.hbm_bytes /
    n_devices``."""
    if analytic is not None:
        flops = analytic.flops / n_devices
        nbytes = analytic.hbm_bytes / n_devices
    else:
        flops, nbytes = record.flops, record.bytes
    return RooflineTerms(flops=flops, bytes_accessed=nbytes,
                         coll_bytes=dict(record.coll_bytes),
                         n_devices=n_devices, model_flops=model_flops,
                         hlo_flops=record.flops, hlo_bytes=record.bytes,
                         card=card)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) per step.

    D = tokens processed: batch*seq for train/prefill, batch for decode.
    Training includes the backward pass (the factor 6 = 2 fwd + 4 bwd);
    prefill/decode use the forward-only factor 2.
    """
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one token per sequence
    return 2.0 * n_active * tokens
