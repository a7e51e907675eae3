"""Parity of the port's KKMEM numeric phase with ``repro.core.kkmem``.

``spgemm`` and the ranged fused multiply-add ``spgemm_ranged_impl`` run on
the same seeded operands through both packages: the output structure
(indptr, indices, the zero tail included) must be equal, values within
atol 1e-5 (both sum each key's products in the same sorted order).
"""

import numpy as np
import pytest
import torch

from conftest import csr_pair_cases
from repro.core import kkmem as ref_kk
from repro.sparse import csr as ref_csr
from repro.sparse import multigrid as ref_mg
from repro_torch.core import kkmem as port_kk
from repro_torch.kernels.convert import csr_from_fields
from repro_torch.sparse.csr import csr_from_dense, resolve_device

CPU = "cpu"
ATOL = 1e-5


def _port(ref):
    return csr_from_fields(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, ref.max_row_nnz,
                           device=CPU)


def _assert_csr_equal(port, ref, atol=ATOL):
    assert tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(ref.indptr))
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(port.data.numpy(), np.asarray(ref.data),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("case", range(8))
def test_spgemm_matches_reference(case):
    A, B = csr_pair_cases(n_examples=8, max_dim=24, seed=4)[case]
    ws = ref_kk.spgemm_symbolic_host(A, B)
    pws = port_kk.spgemm_symbolic_host(_port(A), _port(B))
    assert (pws.c_nnz, pws.c_pad, pws.c_max_row_nnz, pws.flops) == (
        ws.c_nnz, ws.c_pad, ws.c_max_row_nnz, ws.flops)
    ref = ref_kk.spgemm(A, B, ws.c_pad, ws.c_max_row_nnz)
    port = port_kk.spgemm(_port(A), _port(B), ws.c_pad, ws.c_max_row_nnz)
    _assert_csr_equal(port, ref)
    assert port.max_row_nnz == ref.max_row_nnz
    _assert_csr_equal(port_kk.spgemm_full(_port(A), _port(B)), ref_kk.spgemm_full(A, B))
    np.testing.assert_allclose(
        port_kk.spgemm_dense_oracle(_port(A), _port(B)).numpy(),
        np.asarray(ref_kk.spgemm_dense_oracle(A, B)), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spgemm_ranged_matches_reference(seed):
    """Every chunk of a 3-way B row partition, fused onto a nonzero C_prev."""
    rng = np.random.default_rng(seed)
    m, k, n = 13, 17, 11
    a = ((rng.random((m, k)) < 0.3) * rng.standard_normal((m, k))).astype(np.float32)
    b = ((rng.random((k, n)) < 0.3) * rng.standard_normal((k, n))).astype(np.float32)
    prev = ((rng.random((m, n)) < 0.2) * rng.standard_normal((m, n))).astype(np.float32)
    A, C_prev = ref_csr.csr_from_dense(a), ref_csr.csr_from_dense(prev, pad_to=m * n)
    c_pad = m * n
    bounds = (0, 5, 12, k)
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        B_chunk = ref_csr.csr_pad_to(ref_csr.csr_from_dense(b[r0:r1]),
                                     nnz_cap=7 * n, rows=7, max_row_nnz=n)
        ref = ref_kk.spgemm_ranged(A, B_chunk, r0, r1, C_prev, c_pad)
        port = port_kk.spgemm_ranged_impl(_port(A), _port(B_chunk), r0, r1,
                                          _port(C_prev), c_pad)
        _assert_csr_equal(port, ref)
        C_prev = ref


def test_multigrid_product_matches_reference():
    A, _, P = ref_mg.problem("brick3d", 5)
    ws = ref_kk.spgemm_symbolic_host(A, P)
    _assert_csr_equal(port_kk.spgemm(_port(A), _port(P), ws.c_pad),
                      ref_kk.spgemm(A, P, ws.c_pad))


def test_explicit_zero_sums_stay_entries():
    """A key whose products cancel stays in the structure, as in the reference."""
    a = np.array([[1.0, 1.0]], np.float32)
    b = np.array([[2.0], [-2.0]], np.float32)
    ref = ref_kk.spgemm(ref_csr.csr_from_dense(a), ref_csr.csr_from_dense(b), 4)
    port = port_kk.spgemm(csr_from_dense(a, device=CPU), csr_from_dense(b, device=CPU), 4)
    _assert_csr_equal(port, ref)
    assert int(port.indptr[-1]) == 1 and float(port.data[0]) == 0.0


def test_device_none_without_cuda_raises():
    """``device=None`` selects the card; with none present it raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        csr_from_dense(np.eye(3, dtype=np.float32))
    from repro_torch.sparse import multigrid

    with pytest.raises(RuntimeError, match="CUDA"):
        multigrid.problem("laplace3d", 3)
