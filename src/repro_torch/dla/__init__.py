"""repro_torch.dla — dense linear algebra substrate (kernels + blocked
algorithms) on PyTorch."""

from . import blocked, kernels
from .engine import (ExecEngine, Matrix, TraceEngine, View, compile_traces,
                     trace_calls)
from .kernels import KERNELS, KernelDef, kernel_flops

__all__ = ["blocked", "kernels", "ExecEngine", "Matrix", "TraceEngine",
           "View", "compile_traces", "trace_calls", "KERNELS", "KernelDef",
           "kernel_flops"]
