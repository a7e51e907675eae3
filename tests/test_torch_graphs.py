"""The port's graph generators and masked caps against the JAX package.

``repro_torch.sparse.graphs`` draws from the same NumPy generator in the same
order as ``repro.sparse.graphs``, so at one seed the RMAT and power-law
adjacencies and the degree-sorted lower triangle must be bit-for-bit the
reference's (structure, values and ``max_row_nnz``); the masked symbolic
caps computed from them must be equal too.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.symbolic import masked_output_caps as ref_masked_caps
from repro.sparse import graphs as ref_graphs
from repro_torch.core.symbolic import masked_output_caps
from repro_torch.sparse import graphs

GRAPHS = {
    "rmat7": (lambda g, **kw: g.rmat(7, 8, seed=1, **kw)),
    "rmat8_web": (lambda g, **kw: g.rmat(8, 4, a=0.45, b=0.25, c=0.15, seed=3, **kw)),
    "rmat9": (lambda g, **kw: g.rmat(9, 16, seed=7, **kw)),
    "powerlaw256": (lambda g, **kw: g.powerlaw(256, 8, seed=2, **kw)),
    "powerlaw300": (lambda g, **kw: g.powerlaw(300, 4, exponent=2.5, seed=11, **kw)),
}


def assert_csr_equal(port, ref):
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(ref.indptr))
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    assert port.shape == ref.shape
    assert port.max_row_nnz == ref.max_row_nnz


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_and_lower_triangle_bitwise(name):
    make = GRAPHS[name]
    adj, ref_adj = make(graphs, device="cpu"), make(ref_graphs)
    assert_csr_equal(adj, ref_adj)
    L, ref_L = (graphs.lower_triangular_degree_sorted(adj),
                ref_graphs.lower_triangular_degree_sorted(ref_adj))
    assert_csr_equal(L, ref_L)
    # strictly lower triangular, 0/1 values
    ptr, idx = L.indptr.numpy(), L.indices.numpy()
    rows = np.repeat(np.arange(L.n_rows), np.diff(ptr))
    assert (idx[: ptr[-1]] < rows).all()
    assert set(np.unique(L.data.numpy()[: ptr[-1]])) <= {1.0}


@pytest.mark.parametrize("name", ["rmat9", "powerlaw256"])
@pytest.mark.parametrize("n_strips", [1, 3, 5])
def test_masked_output_caps_exact(name, n_strips):
    L = graphs.lower_triangular_degree_sorted(GRAPHS[name](graphs, device="cpu"))
    ref_L = ref_graphs.lower_triangular_degree_sorted(GRAPHS[name](ref_graphs))
    n = L.n_rows
    p_ac = tuple(int(v) for v in np.linspace(0, n, n_strips + 1).round())
    assert (dataclasses.astuple(masked_output_caps(L, p_ac))
            == dataclasses.astuple(ref_masked_caps(ref_L, p_ac)))


def test_graphs_default_to_the_card():
    """device=None selects the CUDA card; without one it raises instead of
    silently staying on the CPU."""
    import torch

    if torch.cuda.is_available():
        assert graphs.rmat(4, 2, seed=0).indptr.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            graphs.rmat(4, 2, seed=0)
