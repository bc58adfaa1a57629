"""repro_torch.serve — serving on the prediction stack, the counterpart of
``repro.serve``.

:mod:`~repro_torch.serve.engine` is the static-batch continuous-batching
engine (step hooks: blocking prefill — one batched pass through the
flash-attention and SSD kernels, then a decode replay of the prompt's
tail — interleaved prefill lanes, one fused ``advance()`` step);
:mod:`~repro_torch.serve.scheduler` drives it — the FIFO baseline or the
:class:`~repro_torch.serve.scheduler.ModelGuidedScheduler`, which scores
admit/defer/interleave candidates on step-cost predictions measured
through a :class:`~repro_torch.tc.session.PredictorSession`.
"""

from .engine import EngineStats, Request, ServeEngine
from .scheduler import (FifoScheduler, ModelGuidedScheduler, Plan,
                        StepCostModel, build_step_cost_model, serve_loop)

__all__ = [
    "EngineStats", "Request", "ServeEngine",
    "FifoScheduler", "ModelGuidedScheduler", "Plan", "StepCostModel",
    "build_step_cost_model", "serve_loop",
]
