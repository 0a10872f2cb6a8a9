"""Device compute ops: decoded-domain ADC scans, IVF probing, top-k merges.

Everything here is built on one identity (the matmul re-design of the
reference's LUT-based ADC, /root/reference/src/rii.h:361-394):

    ADC(q, code) = sum_m ||q_m - codeword_m[code_m]||^2
                 = ||q - decode(code)||^2

so scoring a block of PQ codes against a batch of queries is:

    scores = ||q||^2 - 2 * q @ decode(codes)^T + ||decode(codes)||^2

i.e. a one-hot decode (a matmul) amortized over the query batch, followed by a
dense GEMM — instead of per-byte table lookups.
``||decode(code)||^2`` is precomputed per stored code (the ``code_norms`` cache).
"""

from rii_tpu.ops.decode import onehot_decode, decode_norms
from rii_tpu.ops.scan import linear_scan_topk, subset_scan_topk
from rii_tpu.ops.ivf import ivf_scan_topk

__all__ = [
    "onehot_decode",
    "decode_norms",
    "linear_scan_topk",
    "subset_scan_topk",
    "ivf_scan_topk",
]
