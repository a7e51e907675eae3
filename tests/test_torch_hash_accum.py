"""The hash kernel's plain version against the reference Pallas kernel.

``repro.kernels.hash_accum_spgemm.hash_accum_spgemm_stream`` runs in
``interpret=True`` mode on the CPU; the port's ``hash_accum_plain`` and its
wrapper run on the same staged operands (the eight conformance geometries,
both orders, nonzero ``C_prev``), with the table sized by
``hash_table_slots`` of the exact densest output row. Structure must be
equal, values within atol 1e-4.
"""

import pytest
import torch

from repro.core.planner import hash_table_slots
from repro.kernels import hash_accum_spgemm as ref_hash
from repro_torch.kernels import hash_accum_spgemm as port_hash
from test_backend_conformance import CASES
from test_torch_sparse_accum import ORDERS, assert_stacks_match, stage_csr_case


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_plain_matches_reference_kernel(case, order):
    ref, port, (r0s, r1s), row_cap = stage_csr_case(case)
    table = hash_table_slots(row_cap)
    want = ref_hash.hash_accum_spgemm_stream(*ref, r0s, r1s, order=order,
                                             table_size=table, interpret=True)
    got = port_hash.hash_accum_plain(*port, r0s, r1s, order=order, table_size=table)
    assert_stacks_match(got, want)
    via_wrapper = port_hash.hash_accum_spgemm_stream(*port, r0s, r1s, order=order,
                                                     table_size=table)
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)


def test_full_table_row_fills_every_slot():
    """The dense_row geometry at the table size of its densest row: the
    plain version must still place every key (and agree with a larger
    table on structure and values)."""
    _, port, (r0s, r1s), row_cap = stage_csr_case("dense_row")
    tight = port_hash.hash_accum_plain(*port, r0s, r1s, order="chunk1",
                                       table_size=hash_table_slots(row_cap))
    loose = port_hash.hash_accum_plain(*port, r0s, r1s, order="chunk1",
                                       table_size=4 * hash_table_slots(row_cap))
    assert torch.equal(tight[0], loose[0]) and torch.equal(tight[1], loose[1])
    torch.testing.assert_close(tight[2], loose[2], atol=1e-4, rtol=0)


def test_undersized_table_raises():
    """A table smaller than the densest row fails loudly on the CPU too."""
    _, port, (r0s, r1s), row_cap = stage_csr_case("dense_row")
    small = hash_table_slots(row_cap) // 4
    with pytest.raises(RuntimeError, match="full"):
        port_hash.hash_accum_plain(*port, r0s, r1s, order="chunk2", table_size=small)


def test_table_size_and_probe_bound_match_reference():
    for t in (1, 2, 16, 128):
        assert port_hash.probe_step_bound(t) == ref_hash.probe_step_bound(t)
    _, port, (r0s, r1s), _ = stage_csr_case("empty_rows")
    with pytest.raises(ValueError, match="power of two"):
        port_hash.hash_accum_spgemm_stream(*port, r0s, r1s, order="chunk1",
                                           table_size=12)
    # the Knuth slot is the reference's wrapped int32 product, masked
    for col in (0, 1, 7, 12345, 2**31 - 1):
        want = (col * ref_hash._KNUTH) & 1023
        assert (col * port_hash._KNUTH) & 1023 == want
