"""The dense-slab kernel's plain version against the reference Pallas kernel.

``repro.kernels.ranged_spgemm.ranged_spgemm_stream`` runs in
``interpret=True`` mode on the CPU; the port's ``ranged_spgemm_plain`` and its
wrapper run on the same dense staging (densified strips with ``span`` zero
columns, densified chunk slabs, a nonzero ``c0``) of the eight conformance
geometries under a 3 x 3 partition, in both orders. Values within atol 1e-4.
"""

import numpy as np
import pytest
import torch

from repro.core import chunk_stream as ref_cs
from repro.core.chunking import a_strips, b_chunks
from repro.kernels.ranged_spgemm import ranged_spgemm_stream as ref_stream
from repro.sparse.csr import csr_stack
from repro_torch.core import chunk_stream as port_cs
from repro_torch.kernels.convert import csr_from_fields
from repro_torch.kernels.ranged_spgemm import ranged_spgemm_plain, ranged_spgemm_stream
from test_backend_conformance import CASES, _plan

ATOL = 1e-4
ORDERS = ("chunk1", "chunk2")


def _port(m):
    return csr_from_fields(np.asarray(m.indptr), np.asarray(m.indices),
                           np.asarray(m.data), m.shape, m.max_row_nnz,
                           device="cpu")


def _stage(case: str):
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan("chunk1", A, B)
    As = csr_stack(a_strips(A, plan.p_ac))
    Bs = csr_stack(b_chunks(B, plan.p_b))
    span = Bs.n_rows
    a = np.array(ref_cs._pad_cols(ref_cs._dense_stack(As, levels=1), span))[None]
    slabs = np.array(ref_cs._dense_stack(Bs, levels=1), np.float32)[None]
    # the port stages the same dense operands from the same CSRs
    np.testing.assert_array_equal(
        port_cs._dense_stack(_port(As), levels=1, pad_cols=span)[None].numpy(), a)
    np.testing.assert_array_equal(
        port_cs._dense_stack(_port(Bs), levels=1)[None].numpy(), slabs)
    rng = np.random.default_rng(seed + 2000)
    c0 = rng.standard_normal(a.shape[:3] + (B.n_cols,)).astype(np.float32)
    r0s, _ = plan.b_ranges()
    return a, slabs, c0, r0s


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_plain_matches_reference_kernel(case, order):
    a, slabs, c0, r0s = _stage(case)
    want = np.asarray(ref_stream(a, slabs, c0, r0s, order=order, interpret=True))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, slabs, c0))
    got = ranged_spgemm_plain(ta, tb, tc, r0s, order=order)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(ranged_spgemm_stream(ta, tb, tc, r0s, order=order), got)


def test_orders_agree_and_shapes_are_checked():
    a, slabs, c0, r0s = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                         for x in _stage("skewed_rows"))
    assert torch.equal(ranged_spgemm_plain(a, slabs, c0, r0s, order="chunk1"),
                       ranged_spgemm_plain(a, slabs, c0, r0s, order="chunk2"))
    with pytest.raises(ValueError, match="c0 shape"):
        ranged_spgemm_plain(a, slabs, c0[:, :, :-1], r0s, order="chunk1")
    with pytest.raises(ValueError, match="column-padded"):
        ranged_spgemm_plain(a[..., :1], slabs, c0, r0s, order="chunk1")
    with pytest.raises(ValueError, match="order"):
        ranged_spgemm_plain(a, slabs, c0, r0s, order="rows")
    with pytest.raises(ValueError, match="exceed k_pad"):
        ranged_spgemm_plain(a, slabs, c0, [a.shape[-1]] * len(r0s), order="chunk1")
