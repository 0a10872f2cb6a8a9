"""rii-tpu: a reconfigurable inverted index (IVFADC / PQ) search framework in JAX.

Capability parity target is matsui528/rii (reference: /root/reference/rii/rii.py,
/root/reference/src/rii.h); the accelerator is an NVIDIA GPU (H100), and
everything also runs on the CPU:

- PQ/OPQ codebook training, encoding and PQk-means clustering are batched JAX
  programs (see ``rii_tpu.models``).
- The ADC query path exploits the identity ``ADC(q, code) == ||q - decode(code)||^2``:
  uint8 PQ codes are the *storage* format, while all distance kernels operate in the
  decoded domain as large matmuls (see ``rii_tpu.ops``). On the GPU the linear scan
  over the decoded bf16 replica is a fused Pallas (Triton) kernel that keeps the
  scores in registers; everything else is plain XLA.
- Multi-device scaling shards codes/postings row-wise over a ``jax.sharding.Mesh`` and
  merges per-shard top-k with all-gather collectives (see ``rii_tpu.parallel``).
"""

import os as _os

# the persistent compile cache's fixed home inside the checkout (.gitignore)
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _compile_cache_dir(environ, platforms):
    """Directory the persistent compile cache goes to, or None for none.

    JAX_COMPILATION_CACHE_DIR, when set, wins and JAX reads it itself (None:
    no directory is set in code); otherwise COMPILE_CACHE_DIR. None too when
    RII_TPU_NO_COMPILE_CACHE is set, or when the process is pinned to the CPU
    (CPU compiles are fast, and reloading CPU executables warns per kernel).
    """
    if environ.get("RII_TPU_NO_COMPILE_CACHE"):
        return None
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms and all(
            p.strip() == "cpu" for p in platforms.split(",") if p.strip()):
        return None
    return COMPILE_CACHE_DIR


def _enable_persistent_compile_cache():
    """Persist compiled executables across processes (see
    _compile_cache_dir for where)."""
    try:
        import jax

        cache = _compile_cache_dir(
            _os.environ, getattr(jax.config, "jax_platforms", None))
        if cache:
            jax.config.update("jax_compilation_cache_dir", cache)
    except Exception:
        pass  # never block import on cache setup


_enable_persistent_compile_cache()

from rii_tpu.models.pq import PQ  # noqa: E402
from rii_tpu.models.opq import OPQ  # noqa: E402
from rii_tpu.rii import Rii  # noqa: E402
from rii_tpu.serving import QueryServer  # noqa: E402

__version__ = "0.3.0"

__all__ = ["PQ", "OPQ", "Rii", "QueryServer", "__version__"]
