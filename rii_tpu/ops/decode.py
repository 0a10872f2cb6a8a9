"""PQ decode as one-hot matmuls — the matmul replacement for a gather.

A one-hot matmul trades O(Ks) extra FLOPs per code byte for a dense
contraction in place of a per-element gather (``dtable[m][code]``); the cost is
paid once per scanned block, amortized over the whole query batch. On the GPU
a shared-memory codebook lookup is the likely better answer (ROADMAP D1).
"""

import jax
import jax.numpy as jnp
from jax import lax


def onehot_decode(codes, codewords, dtype=jnp.float32, precision=lax.Precision.HIGHEST):
    """Decode PQ codes via one-hot matmul.

    Args:
        codes: (B, M) integer code ids.
        codewords: (M, Ks, Ds) float codebooks.
        dtype: compute dtype for the one-hot contraction (bf16 on the fast path).

    Returns:
        (B, M * Ds) reconstructed vectors in `dtype`.
    """
    b = codes.shape[0]
    ks = codewords.shape[1]
    oh = jax.nn.one_hot(codes, ks, dtype=dtype)  # (B, M, Ks)
    dec = jnp.einsum("bmk,mkd->bmd", oh, codewords.astype(dtype), precision=precision)
    return dec.reshape(b, -1)


def onehot_decode_exact(codes, codewords):
    """EXACT f32 decode at bf16 one-hot traffic.

    0 and 1 are exactly representable in bf16, so a bf16 one-hot contracted
    against the FULL-PRECISION f32 codewords (HIGHEST precision, f32
    accumulate) reproduces the f32 gather-decode bit-for-bit while the big
    (B, M, Ks) one-hot tensor moves at half the bytes of the f32 variant.
    Used by the candidate-rescore paths, where distances must be exact ADC
    (the architecture invariant) but B = Q * k_fetch can reach ~20k rows.
    """
    b = codes.shape[0]
    ks = codewords.shape[1]
    oh = jax.nn.one_hot(codes, ks, dtype=jnp.bfloat16)  # (B, M, Ks) of 0/1
    dec = jnp.einsum("bmk,mkd->bmd", oh, codewords.astype(jnp.float32),
                     precision=lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    return dec.reshape(b, -1)


def build_decoded_cache(codes, codewords, block=4096, dtype=jnp.bfloat16):
    """Decode the whole (cap, M) code array to a (cap, D) bf16 replica.

    One-time build cost for the speed-of-light scan path: queries then score
    against the replica with a single HBM-bound GEMM per block instead of
    re-decoding per scan. cap must be a multiple of block.
    """
    import jax.numpy as _jnp
    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("block",))
    def _build(codes_, codewords_, block):
        cap = codes_.shape[0]
        nb = cap // block
        blocks = codes_.reshape(nb, block, -1)

        def f(cb):
            return onehot_decode(cb, codewords_, dtype=_jnp.float32).astype(dtype)

        return lax.map(f, blocks).reshape(cap, -1)

    cap = codes.shape[0]
    blk = min(block, cap)
    assert cap % blk == 0
    return _build(codes, codewords, blk)


@jax.jit
def dtable(query, codewords):
    """Classic ADC distance table: (M, Ks) of ||q_m - codeword_{m,k}||^2.

    Parity helper for the reference's DTable (/root/reference/src/rii.h:361-373).
    The hot paths never materialize it (they use the decoded-domain identity),
    but it is exposed for oracles, debugging, and external consumers:
    ADC(q, code) == dtable(q)[m, code_m] summed over m.
    """
    m, ks, ds = codewords.shape
    q_sub = query.reshape(m, 1, ds)
    diff = q_sub - codewords
    return jnp.sum(diff * diff, axis=-1)


def adc_oracle(query, codes, codewords):
    """Reference-formulation ADC distances via the dtable (slow, exact):
    sum_m dtable[m, codes[:, m]]."""
    m = codewords.shape[0]
    dt = dtable(query, codewords)  # (M, Ks)
    idx = codes.astype(jnp.int32)
    gathered = jax.vmap(lambda mm: dt[mm][idx[:, mm]])(jnp.arange(m))
    return jnp.sum(gathered, axis=0)


def decode_norms(codes, codewords, precision=lax.Precision.HIGHEST):
    """||decode(code)||^2 for each code row: (B, M) -> (B,) f32.

    Uses the per-subspace codeword norm table (M, Ks) and a one-hot contraction,
    so it is exact in f32.
    """
    ks = codewords.shape[1]
    cnorms = jnp.sum(codewords * codewords, axis=-1)  # (M, Ks)
    oh = jax.nn.one_hot(codes, ks, dtype=jnp.float32)  # (B, M, Ks)
    return jnp.einsum("bmk,mk->b", oh, cnorms, precision=precision)
