"""Utilities: dataset IO (fvecs/ivecs/bvecs), recall metrics, timing."""

from rii_tpu.utils.io import fvecs_read, ivecs_read, bvecs_read_batches
from rii_tpu.utils.recall import recall_at_r
from rii_tpu.utils.profiling import trace, benchmark_queries

__all__ = [
    "fvecs_read",
    "ivecs_read",
    "bvecs_read_batches",
    "recall_at_r",
    "trace",
    "benchmark_queries",
]
