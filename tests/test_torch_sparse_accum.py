"""The ESC kernel's plain version against the reference Pallas kernel.

``repro.kernels.sparse_accum_spgemm.sparse_accum_spgemm_stream`` runs as the
reference's own tests run it on the CPU (``interpret=True``); the port's
``sparse_accum_plain`` and its wrapper (which takes the plain version for CPU
tensors) run on the same staged operands: the eight edge geometries of the
backend conformance suite, a 3 x 3 strip/chunk partition, both streaming
orders, and a nonzero ``C_prev``. Structure must be equal (the zero tail
included), values within atol 1e-4, the reference's tolerance.
"""

import numpy as np
import pytest
import torch

from repro.core.chunking import a_strips, b_chunks
from repro.kernels.sparse_accum_spgemm import sparse_accum_spgemm_stream as ref_stream
from repro.sparse.csr import csr_from_dense, csr_pad_to, csr_stack
from repro_torch.kernels.convert import csr_from_fields
from repro_torch.kernels.sparse_accum_spgemm import (
    esc_workspace, sparse_accum_plain, sparse_accum_spgemm_stream,
)
from repro_torch.sparse.csr import CSR
from test_backend_conformance import CASES, _plan

ATOL = 1e-4
ORDERS = ("chunk1", "chunk2")


def _pattern(m):
    """Boolean structure (stored entries, zeros included) of a reference CSR."""
    ptr, idx = np.asarray(m.indptr), np.asarray(m.indices)
    out = np.zeros(m.shape, bool)
    rows = np.repeat(np.arange(m.n_rows), ptr[1:] - ptr[:-1])
    out[rows, idx[: ptr[-1]]] = True
    return out


def _port(m):
    return csr_from_fields(np.asarray(m.indptr), np.asarray(m.indices),
                           np.asarray(m.data), m.shape, m.max_row_nnz,
                           device="cpu")


def stage_csr_case(case: str):
    """Staged operands of one conformance case under a thirds x thirds plan,
    with a random nonzero C_prev per strip. Returns the reference stacks, the
    port stacks, the chunk ranges and the exact densest output row."""
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan("chunk1", A, B)
    strips, chunks = a_strips(A, plan.p_ac), b_chunks(B, plan.p_b)
    strip_rows, n_cols = strips[0].n_rows, B.n_cols
    rng = np.random.default_rng(seed + 1000)
    product = (_pattern(A).astype(np.int64) @ _pattern(B).astype(np.int64)) > 0
    c0s, unions = [], []
    for s, e in zip(plan.p_ac[:-1], plan.p_ac[1:]):
        c0 = ((rng.random((strip_rows, n_cols)) < 0.25)
              * rng.standard_normal((strip_rows, n_cols))).astype(np.float32)
        union = c0 != 0
        union[: e - s] |= product[s:e]
        c0s.append(c0)
        unions.append(union)
    c_cap = max(8, -(-max(int(u.sum()) for u in unions) // 8) * 8)
    row_cap = max(1, max(int(u.sum(1).max()) for u in unions))
    C0st = csr_stack([csr_stack([
        csr_pad_to(csr_from_dense(c, pad_to=c_cap), max_row_nnz=c_cap) for c in c0s])])
    Ast, Bst = csr_stack([csr_stack(strips)]), csr_stack([csr_stack(chunks)])
    ref = (Ast, Bst, C0st)
    port = tuple(_port(m) for m in ref)
    r0s, r1s = plan.b_ranges()
    return ref, port, (r0s, r1s), row_cap


def assert_stacks_match(got, want):
    ip, ix, d = (t.numpy() for t in got)
    np.testing.assert_array_equal(ip, np.asarray(want[0]))
    np.testing.assert_array_equal(ix, np.asarray(want[1]))
    np.testing.assert_allclose(d, np.asarray(want[2]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_esc_plain_matches_reference_kernel(case, order):
    ref, port, (r0s, r1s), row_cap = stage_csr_case(case)
    want = ref_stream(*ref, r0s, r1s, order=order, interpret=True)
    got = sparse_accum_plain(*port, r0s, r1s, order=order)
    assert_stacks_match(got, want)
    # on CPU tensors the wrapper is the plain version
    via_wrapper = sparse_accum_spgemm_stream(*port, r0s, r1s, order=order,
                                             row_cap=row_cap)
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)


def test_esc_workspace_sizes():
    """One row's sort workspace: products plus accumulator, to a power of two."""
    assert esc_workspace(27, 8, 27) == (256, 256 * 12 + 27 * 8 + 8)
    assert esc_workspace(81, 8, 81)[0] == 1024
    assert esc_workspace(0, 0, 1) == (1, 32)


def test_esc_rejects_unknown_order_and_mismatched_stacks():
    _, (Ast, Bst, C0st), (r0s, r1s), _ = stage_csr_case("empty_rows")
    with pytest.raises(ValueError, match="order"):
        sparse_accum_plain(Ast, Bst, C0st, r0s, r1s, order="chunk3")
    short = CSR(C0st.indptr[:, :2], C0st.indices[:, :2], C0st.data[:, :2],
                C0st.shape, C0st.max_row_nnz)
    with pytest.raises(ValueError, match="leading axes"):
        sparse_accum_plain(Ast, Bst, short, r0s, r1s, order="chunk1")
