"""The §5 baselines of the port (``repro_torch.core.baselines``) against the
reference's ``repro.core.baselines`` on the CPU, on the same numpy inputs, at
the reference's LP tolerance ``rtol=1e-4, atol=1e-5``.  kNN indices must be
equal: the data are continuous random draws, so no two distances tie."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as r_bl
from repro_torch.core import baselines as t_bl
from repro_torch.core.grf import CSRGraph
from repro_torch.core.label_prop import label_propagate

RTOL, ATOL = 1e-4, 1e-5


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _points(n, d, seed):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


@pytest.mark.parametrize("n,d,sigma", [(30, 4, 1.0), (67, 5, 0.8)])
def test_exact_transition_matrix_matches_reference(n, d, sigma):
    x = _points(n, d, n)
    got = t_bl.exact_transition_matrix(torch.as_tensor(x), sigma)
    _close(got, r_bl.exact_transition_matrix(jnp.asarray(x),
                                             jnp.asarray(sigma)))
    assert torch.all(torch.diagonal(got) == 0)
    y = np.random.RandomState(1).randn(n, 3).astype(np.float32)
    _close(t_bl.exact_matvec(got, torch.as_tensor(y)),
           r_bl.exact_matvec(jnp.asarray(np.asarray(got)), jnp.asarray(y)))


@pytest.mark.parametrize("block", [16, 1024])
def test_streaming_exact_matvec_matches_reference(block):
    n, d, c = 67, 5, 3
    x, y = _points(n, d, 2), _points(n, c, 3)
    got = t_bl.streaming_exact_matvec(torch.as_tensor(x), torch.as_tensor(y),
                                      0.8, block=block)
    _close(got, r_bl.streaming_exact_matvec(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(0.8), block=16))
    _close(got, t_bl.exact_transition_matrix(torch.as_tensor(x), 0.8)
           @ torch.as_tensor(y))


@pytest.mark.parametrize("n,k,block", [(40, 5, 16), (25, 4, 8), (70, 4, 2048)])
def test_knn_graph_matches_reference(n, k, block):
    x = _points(n, 3, n + k)
    got = t_bl.build_knn_graph(torch.as_tensor(x), k, 1.3, block=block)
    want = r_bl.build_knn_graph(jnp.asarray(x), k, jnp.asarray(1.3),
                                block=16)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    _close(got.weights, want.weights)
    np.testing.assert_allclose(got.weights.sum(1).numpy(), 1.0, rtol=1e-5)
    assert not (got.indices == torch.arange(n)[:, None]).any()  # no self edge
    y = _points(n, 2, 9)
    _close(t_bl.knn_matvec(got, torch.as_tensor(y)),
           r_bl.knn_matvec(want, jnp.asarray(y)))


def test_knn_graph_is_a_walkable_csr_graph():
    """The kNN graph goes into the GRF backend unchanged: k edges a row."""
    n, k = 50, 4
    g = t_bl.build_knn_graph(torch.as_tensor(_points(n, 6, 4)), k, 2.0,
                             block=16)
    csr = CSRGraph.from_csr(np.arange(n + 1) * k, g.indices.reshape(-1),
                            g.weights.reshape(-1), device="cpu")
    assert csr.nnz == n * k and csr.density == k / n
    y0 = torch.as_tensor(_points(n, 2, 5))
    dense = torch.as_tensor(csr.dense_p())
    _close(label_propagate(lambda y: t_bl.knn_matvec(g, y), y0, 0.5, 8),
           label_propagate(lambda y: dense @ y, y0, 0.5, 8).numpy())
