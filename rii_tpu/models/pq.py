"""Product Quantization codec, trained and executed as batched JAX programs.

Drop-in replacement for the ``nanopq.PQ`` contract the reference depends on
(SURVEY.md section 2.4; usage at /root/reference/rii/rii.py:33-37,150,185):

- ``PQ(M, Ks=256, verbose=False)``; ``fit(vecs)`` trains codewords, returns self.
- ``codewords``: float32 (M, Ks, Ds) ndarray.
- ``encode(vecs) -> (N, M) uint8``; ``decode(codes) -> (N, D) float32``.
- ``code_dtype``, ``verbose``, ``__eq__`` (needed by ``Rii.merge``).

Batched: all M sub-space codebooks train in one vmapped k-means program
(``kmeans_fit_batched``); encoding embeds the M codebooks block-diagonally in
one (D, M*Ks) weight so each block is a single dense GEMM followed by a
per-subspace argmin (see ``_encode_weight``), submitted chunk-at-a-time as one
device program.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from rii_tpu.models.kmeans import kmeans_fit_batched

_PREC = lax.Precision.HIGHEST

# Encode/decode process the database in fixed-size blocks so the jit cache stays
# small and the transient (B, M, Ks) distance tensor stays on-chip friendly.
# Blocks are grouped into chunks submitted as ONE device program each (lax.map),
# bounding host<->device traffic per call to ~1 GB at D=128.
_ENCODE_BLOCK = 16384
_CHUNK = 2_097_152


def _encode_weight(codewords):
    """(M, Ks, Ds) -> block-diagonal (D, M*Ks) f32 and csq (M, Ks).

    A per-subspace cross term has only a Ds-deep contraction (Ds=4 at M=32,
    D=128) — a tiny fraction of a matrix unit's depth. Embedding the M codebooks on the diagonal of
    one (D, M*Ks) weight turns encode into a single dense GEMM; the harmless
    off-block products are never read because argmin runs within each
    subspace's Ks slice. ||v||^2 is dropped entirely: it is constant within a
    (b, m) row and cannot change the argmin over k.
    """
    m, ks, ds = codewords.shape
    w = np.zeros((m * ds, m * ks), np.float32)
    cw = np.asarray(codewords, np.float32)
    for mm in range(m):
        w[mm * ds:(mm + 1) * ds, mm * ks:(mm + 1) * ks] = cw[mm].T
    csq = (cw * cw).sum(axis=-1)  # (M, Ks)
    return w, csq


def _encode_block_core(vecs, w, csq):
    """vecs: (B, D), w: (D, M*Ks) block-diag, csq: (M, Ks) -> (B, M) uint8."""
    b = vecs.shape[0]
    m, ks = csq.shape
    cross = jnp.dot(vecs, w, precision=_PREC)  # (B, M*Ks), one dense GEMM
    dists = csq[None] - 2.0 * cross.reshape(b, m, ks)
    # uint8 on device: the result crosses the host<->device link (4x less
    # traffic than int32)
    return jnp.argmin(dists, axis=-1).astype(jnp.uint8)


@jax.jit
def _encode_blocks(vecs_blocks, w, csq):
    """(nb, B, D) -> (nb, B, M) uint8: the whole chunk in ONE dispatch.

    One jit call per outer chunk instead of per block, so dispatch overhead
    is paid per chunk."""
    return lax.map(lambda v: _encode_block_core(v, w, csq), vecs_blocks)


def _decode_block_core(codes, codewords):
    """codes: (B, M) int -> (B, D) f32 reconstruction via one-hot matmuls.

    Per subspace, onehot (B, Ks) @ codewords[m] (Ks, Ds): a matmul instead
    of a take_along_axis gather (the one-hot encode/decode is a candidate for
    a GPU rewrite, ROADMAP D1)."""
    b, m = codes.shape
    ks = codewords.shape[1]
    oh = jax.nn.one_hot(codes.astype(jnp.int32), ks, dtype=jnp.float32,
                        axis=-1)  # (B, M, Ks)
    sub = jnp.einsum("bmk,mkd->bmd", oh, codewords, precision=_PREC)
    return sub.reshape(b, -1)


@jax.jit
def _decode_blocks(codes_blocks, codewords):
    """(nb, B, M) -> (nb, B, D) f32: the whole chunk in one dispatch."""
    return lax.map(lambda c: _decode_block_core(c, codewords), codes_blocks)


def _as_blocks(n, block):
    """Yield (start, length) covering [0, n) in chunks of `block`."""
    for s in range(0, n, block):
        yield s, min(block, n - s)


class PQ:
    """Product quantizer with Ks codewords per each of M sub-spaces.

    Args:
        M: number of sub-spaces; D must be divisible by M.
        Ks: codewords per sub-space; must be <= 256 so codes fit in uint8
            (same constraint as /root/reference/rii/rii.py:35).
        verbose: print training info.
        seed: PRNG seed for deterministic training.
    """

    def __init__(self, M, Ks=256, verbose=False, seed=123):
        assert 0 < Ks <= 256, "Ks must be <= 256 so that each code fits in uint8"
        self.M = int(M)
        self.Ks = int(Ks)
        self.verbose = bool(verbose)
        self.seed = int(seed)
        self.code_dtype = np.uint8
        self.codewords = None  # (M, Ks, Ds) float32, set by fit()
        self.Ds = None

    # -- training ---------------------------------------------------------

    @classmethod
    def from_codewords(cls, codewords, verbose=False):
        """Build a fitted codec from an EXISTING (M, Ks, Ds) codeword array —
        the migration path for codebooks trained elsewhere (e.g. a nanopq.PQ
        from a reference deployment: pass ``nanopq_pq.codewords``). Codes
        produced by the source quantizer decode identically here, so an
        existing uint8 code database can be ingested via Rii.add_codes
        without re-encoding."""
        codewords = np.ascontiguousarray(codewords, dtype=np.float32)
        assert codewords.ndim == 3, "codewords must be (M, Ks, Ds)"
        m, ks, ds = codewords.shape
        pq = cls(M=m, Ks=ks, verbose=verbose)
        pq.codewords = codewords
        pq.Ds = ds
        return pq

    def fit(self, vecs, iter=20, seed=None):
        """Train codewords on vecs (N, D) float32. Returns self (chainable)."""
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        N, D = vecs.shape
        assert D % self.M == 0, "D must be divisible by M"
        assert self.Ks <= N, "N must be >= Ks"
        self.Ds = D // self.M
        if seed is not None:
            self.seed = int(seed)
        if self.verbose:
            print(f"PQ training: M={self.M}, Ks={self.Ks}, D={D}, N={N}, iter={iter}")

        # (N, D) -> (M, N, Ds): one k-means problem per subspace, all fit at once.
        sub = jnp.asarray(vecs.reshape(N, self.M, self.Ds).transpose(1, 0, 2))
        key = jax.random.PRNGKey(self.seed)
        centers, _ = kmeans_fit_batched(key, sub, k=self.Ks, iters=int(iter))
        self.codewords = np.asarray(centers, dtype=np.float32)  # (M, Ks, Ds)
        return self

    # -- transform --------------------------------------------------------

    def _check_fitted(self):
        assert self.codewords is not None, "Please fit the PQ instance first"

    def encode(self, vecs):
        """vecs (N, D) float32 -> PQ codes (N, M) uint8."""
        self._check_fitted()
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        N, D = vecs.shape
        assert D == self.M * self.Ds
        w, csq = _encode_weight(self.codewords)
        wd, csqd = jnp.asarray(w), jnp.asarray(csq)
        out = np.empty((N, self.M), dtype=np.uint8)
        for s, ln in _as_blocks(N, _CHUNK):
            nb = -(-ln // _ENCODE_BLOCK)
            npad = nb * _ENCODE_BLOCK
            chunk = vecs[s : s + ln]
            if npad != ln:  # pad the tail chunk by repeating row 0
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[:1], (npad - ln, D))])
            blocks = jnp.asarray(chunk.reshape(nb, _ENCODE_BLOCK, D))
            codes = _encode_blocks(blocks, wd, csqd)
            out[s : s + ln] = np.asarray(
                codes.reshape(npad, self.M)[:ln], dtype=np.uint8)
        return out

    def decode(self, codes):
        """codes (N, M) uint8 -> reconstructed vecs (N, D) float32."""
        self._check_fitted()
        codes = np.asarray(codes)
        assert codes.ndim == 2 and codes.shape[1] == self.M
        assert codes.dtype == self.code_dtype
        cw = jnp.asarray(self.codewords)
        N = codes.shape[0]
        out = np.empty((N, self.M * self.Ds), dtype=np.float32)
        for s, ln in _as_blocks(N, _CHUNK):
            nb = -(-ln // _ENCODE_BLOCK)
            npad = nb * _ENCODE_BLOCK
            chunk = codes[s : s + ln]
            if npad != ln:
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[:1], (npad - ln, self.M))])
            dec = _decode_blocks(
                jnp.asarray(chunk.reshape(nb, _ENCODE_BLOCK, self.M)), cw)
            out[s : s + ln] = np.asarray(
                dec.reshape(npad, -1)[:ln], dtype=np.float32)
        return out

    # -- misc --------------------------------------------------------------

    @property
    def D(self):
        return None if self.Ds is None else self.M * self.Ds

    def __eq__(self, other):
        if type(other) is not type(self):
            return False
        if (self.M, self.Ks) != (other.M, other.Ks):
            return False
        if (self.codewords is None) != (other.codewords is None):
            return False
        if self.codewords is None:
            return True
        return np.array_equal(self.codewords, other.codewords)

    def __repr__(self):
        return f"{type(self).__name__}(M={self.M}, Ks={self.Ks}, fitted={self.codewords is not None})"
