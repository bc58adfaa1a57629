"""repro_torch.tc — cache-aware tensor-contraction prediction (paper Ch. 6)
and the device measurement of the hand-written kernels' tiles.

The counterpart of ``repro.tc``: a §6.1 generator extended with
batched-kernel patterns (:mod:`~repro_torch.tc.kernels`), a deduplicated
cache-aware micro-benchmark suite that reports its own cost
(:mod:`~repro_torch.tc.suite`), a :class:`ContractionPredictor` that
compiles the whole candidate set through the
:class:`~repro_torch.core.predict.PredictionEngine`
(:mod:`~repro_torch.tc.predictor`), size-parametric signature models
(:mod:`~repro_torch.tc.parametric`), an einsum-path layer that composes
per-step predictors into chain rankings (:mod:`~repro_torch.tc.chains`),
and the CUDA kernels' tile families (:mod:`~repro_torch.tc.device`).
:class:`~repro_torch.tc.session.PredictorSession` is the single entry
point over all of them.
"""

from .chains import (MAX_OPERANDS, ChainPath, ChainPredictor, ChainSizeSweep,
                     ChainSpec, ChainStep, RankedChain, compose_chain_runtime,
                     execute_chain, execute_chain_reference,
                     execute_path_reference, rank_einsum_sweep,
                     validate_paths)
from .device import (DEVICE_KERNELS, RESIDENT, TIGHT, DeviceRanked,
                     DeviceSuite, device_key, smem_class)
from .kernels import (BATCH_SUFFIX, BATCHABLE_KERNELS, base_kernel,
                      generate_algorithms, generate_batched_algorithms,
                      is_batched_kernel, kernel_batch_dims, slice_call_bytes,
                      validate_algorithms)
from .parametric import (ParametricModel, ParametricModels, SignatureKey,
                         cost_exponents, key_at, signature_dims,
                         signature_of, size_point)
from .predictor import (ContractionPredictor, ContractionSizeSweep,
                        RankedContraction, rank_contraction_sweep)
from .session import PredictorSession
from .suite import (COLD, WARM, MicroBenchmark, MicroBenchmarkKey,
                    MicroBenchmarkSuite, benchmark_key, canonical_equation)

__all__ = [
    "BATCH_SUFFIX", "BATCHABLE_KERNELS", "base_kernel",
    "generate_algorithms", "generate_batched_algorithms",
    "is_batched_kernel", "kernel_batch_dims", "slice_call_bytes",
    "validate_algorithms",
    "ContractionPredictor", "ContractionSizeSweep", "RankedContraction",
    "rank_contraction_sweep",
    "COLD", "WARM", "MicroBenchmark", "MicroBenchmarkKey",
    "MicroBenchmarkSuite", "benchmark_key", "canonical_equation",
    "MAX_OPERANDS", "ChainPath", "ChainPredictor", "ChainSizeSweep",
    "ChainSpec", "ChainStep", "RankedChain", "compose_chain_runtime",
    "execute_chain", "execute_chain_reference", "execute_path_reference",
    "rank_einsum_sweep", "validate_paths",
    "PredictorSession",
    "ParametricModel", "ParametricModels", "SignatureKey",
    "cost_exponents", "key_at", "signature_dims", "signature_of",
    "size_point",
    "DEVICE_KERNELS", "DeviceRanked", "DeviceSuite", "device_key",
    "smem_class", "RESIDENT", "TIGHT",
]
