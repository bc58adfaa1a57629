"""repro_torch.core — measurement-based performance modeling & prediction.

The paper's primary contribution (Peise 2017): piecewise-polynomial kernel
performance models generated once per setup, instantaneous predictions of
blocked-algorithm runtime, algorithm ranking, block-size optimization,
and cache-aware micro-benchmarks for tensor contractions.  The counterpart
of ``repro.core``: its numpy paths, the float64 prediction backend as a
torch program (``PredictionEngine(backend="torch")``), and the Ch. 6
contraction layer on the card (:mod:`~repro_torch.core.contractions`).
"""

from .fitting import (Polynomial, StackedPolynomials, error_measure,
                      fit_relative, monomial_basis, relative_errors,
                      stack_polynomials)
from .grids import Domain, grid_points
from .model import CaseModel, ModelSet, PerformanceModel, Piece
from .modelgen import (GenerationReport, KernelBenchmark, generate_model,
                       generate_model_set)
from .predict import (BACKENDS, CompiledCalls, FusedBatch, KernelCall,
                      PredictionEngine, TraceCache, absolute_relative_error,
                      compile_calls, predict_efficiency, predict_performance,
                      predict_runtime, relative_error)
from .refinement import GeneratorConfig, refine, stats_sample_fn
from .sampler import STATS, Stats, measure_calls, measure_single
from .selection import (RankedAlgorithm, optimize_algorithm_and_block_size,
                        optimize_block_size, performance_yield,
                        rank_algorithms, rank_einsum_paths, select_algorithm,
                        select_contraction_algorithm, select_einsum_path)
from .transfer import (D2H, H2D, TransferModel, fit_transfer,
                       measure_transfers)

__all__ = [
    "Polynomial", "StackedPolynomials", "error_measure", "fit_relative",
    "monomial_basis", "relative_errors", "stack_polynomials", "Domain",
    "grid_points", "CaseModel", "ModelSet", "PerformanceModel", "Piece",
    "GenerationReport", "KernelBenchmark", "generate_model",
    "generate_model_set", "BACKENDS", "CompiledCalls", "FusedBatch",
    "KernelCall",
    "PredictionEngine", "TraceCache", "compile_calls",
    "absolute_relative_error", "predict_efficiency", "predict_performance",
    "predict_runtime", "relative_error", "GeneratorConfig", "refine",
    "stats_sample_fn", "STATS", "Stats", "measure_calls", "measure_single",
    "RankedAlgorithm", "optimize_algorithm_and_block_size",
    "optimize_block_size", "performance_yield", "rank_algorithms",
    "rank_einsum_paths", "select_algorithm",
    "select_contraction_algorithm", "select_einsum_path", "D2H", "H2D",
    "TransferModel", "fit_transfer",
    "measure_transfers",
]
