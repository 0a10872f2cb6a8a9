"""Card-only tests: the fused replica kernel as compiled for the GPU (no
interpret mode) against the plain XLA scan. They skip without a GPU; see
tests/conftest.py for how to run them on the card."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rii_tpu.ops.replica_scan import replica_scan_topk
from rii_tpu.ops.scan import linear_scan_topk_decoded


@pytest.mark.gpu
@pytest.mark.parametrize("qn", [1, 128, 1024])
def test_compiled_kernel_matches_xla(gpu, qn):
    k1, k2 = jax.random.split(jax.random.PRNGKey(qn))
    cap, d = 1 << 18, 128
    dec = (jax.random.normal(k1, (cap, d)) * 10).astype(jnp.bfloat16)
    nrm = jnp.sum(dec.astype(jnp.float32) ** 2, axis=1)
    nrm = nrm.at[cap - 1000:].set(jnp.inf)  # padding
    q = jax.random.normal(k2, (qn, d)) * 10
    d_k, i_k = replica_scan_topk(q, dec, nrm, topk=10, recall_target=None)
    d_x, i_x = linear_scan_topk_decoded(q, dec, nrm, topk=10, block=1 << 16)
    i_k, i_x = np.asarray(i_k), np.asarray(i_x)
    assert (i_k < cap - 1000).all()
    assert (i_k[:, 0] == i_x[:, 0]).mean() >= 0.99
    np.testing.assert_allclose(np.asarray(d_k)[:, 0], np.asarray(d_x)[:, 0],
                               rtol=1e-4)
