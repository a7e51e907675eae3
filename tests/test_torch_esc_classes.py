"""The ESC merge's classed launch (``kernels/sparse_accum_spgemm.py``,
``csrc/sparse_accum_spgemm.cu``) on the CPU, where no kernel runs.

A call whose launch-wide bound passes a block's shared memory counts its
steps' keys and launches, chunk by chunk, one kernel per step class over
that class's rows (``esc_launch_plan``, ``step_classes``):

* every non-empty (chunk, row) step is listed once, under the first class
  its keys fit; an empty step under none;
* each class's shared memory follows its own keys ``W`` (a warp class
  ``W`` sort slots of 12 bytes and ``min(row_cap, W)`` accumulator slots of
  8 a warp, a block class ``W`` sort slots, the global class a tile of 8
  bytes a key) and fits ``SMEM_PER_BLOCK``;
* the classed launch emulated step by step (``esc_classed_emulated`` of
  ``tests/test_torch_esc_global.py``: a warp's, a block's or the global
  class's tiled merge a step, nothing for an empty step) equals
  ``sparse_accum_plain`` bit for bit on the conformance corpus and on L x L
  of an RMAT scale-9 graph, at class cuts small enough that every class and
  the global one take steps, with and without C_prev, and it launches what
  ``kernels_per_call`` counts; so do the class-edge rows of
  ``chip_smoke.py``, with the block and global classes' keys in 32 bits and
  in 64 (``key_layout``: 32 where the call's columns and the class's slots
  fit);
* the global class's tiled sort (tiles sorted in shared memory, only the
  sub-stages of stride at least a tile as passes over global memory) sorts
  unique 64-bit keys for every power of two from 2 to 2^16 at several tile
  sizes, with m (m + 1) / 2 global passes for 2^m tiles;
* the RMAT scale-12 L x L plan of ``chip_smoke.py``'s ``esc_global_phase``
  has the step table of PERF.md row 2b.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro_torch.kernels import sparse_accum_spgemm as esc
from repro_torch.sparse.csr import CSR
from test_backend_conformance import CASES
from test_torch_esc_global import classed, esc_classed_emulated, rmat12_plan, tiled_network
from test_torch_sparse_accum import stage_csr_case

ORDERS = ("chunk1", "chunk2")


def empty_c0(C0st: CSR) -> CSR:
    """C_prev of the same stacks and capacity with no entry."""
    return CSR(torch.zeros_like(C0st.indptr), torch.zeros_like(C0st.indices),
               torch.zeros_like(C0st.data), C0st.shape, C0st.max_row_nnz)


def assert_classes_list_each_step(plan, keys):
    """``plan`` lists each non-empty step of ``keys`` ([n_b, rows]) once,
    under the first class whose most keys holds it, in (chunk, class, row)
    order; an empty step in no class."""
    n_b, rows = keys.shape
    n_cls = len(plan.classes)
    seen = torch.zeros(n_b, rows, dtype=torch.int64)
    for j in range(n_b):
        for i, c in enumerate(plan.classes):
            first, last = plan.starts[j * n_cls + i], plan.starts[j * n_cls + i + 1]
            got = plan.items[first:last].long()
            assert torch.equal(got, got.sort().values)
            n = keys[j, got]
            below = plan.classes[i - 1].max_keys if i else 0
            assert bool(((n > below) & (n <= c.max_keys)).all()), c.name
            seen[j, got] += 1
    assert torch.equal(seen, (keys > 0).long())
    assert plan.routes["empty"] == int((keys == 0).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_classes_take_each_counted_step_once_by_its_keys(monkeypatch, case):
    _, port, (r0s, r1s), row_cap = stage_csr_case(case)
    classed(monkeypatch, (1, 2, 4, 8))
    plan = esc.esc_launch_plan(*port, r0s, r1s, row_cap=row_cap)
    keys = esc.step_keys(*port, r0s, r1s).permute(2, 0, 1, 3).reshape(len(r0s), -1)
    assert plan.split
    assert_classes_list_each_step(plan, keys)


@pytest.mark.parametrize("row_cap", [1, 100, 128, 3_253, 1 << 20])
def test_class_shared_memory_follows_its_keys(row_cap):
    classes = esc.step_classes(row_cap)
    assert [c.name for c in classes] == list(esc.ROUTES[1:])
    for c in classes:
        assert c.block_smem <= esc.SMEM_PER_BLOCK, c
        if c.kind == "warp":
            acc = min(row_cap, c.max_keys)
            assert c.acc_cap == acc
            assert c.smem_per_warp == -(-(c.max_keys * 12 + acc * 8) // 16) * 16
            warps = esc.block_warps(c.smem_per_warp)
            assert (c.threads, c.smem) == (warps * 32, warps * c.smem_per_warp)
        elif c.kind == "block":
            assert c.smem == c.max_keys * 12 and c.threads == min(1024, c.max_keys // 2)
        else:
            assert c.work_cap == classes[-2].max_keys and c.smem == c.work_cap * 8
    # the register classes' steps pack 8 warps a block, several blocks an SM
    first = classes[0]
    assert first.max_keys == 128 and first.threads == 256 and 4 * first.smem < 232_448


def test_step_classes_refuse_a_block_past_shared_memory(monkeypatch):
    monkeypatch.setattr(esc, "STEP_CLASSES", esc.STEP_CLASSES[:-1] + (
        ("block16384", "block", 32_768),))
    with pytest.raises(ValueError, match="shared memory"):
        esc.step_classes(100)


def assert_emulation_matches_plain(ops, row_cap):
    r0s, r1s = ops[3], ops[4]
    got, launches = esc_classed_emulated(*ops, row_cap=row_cap)
    plan = esc.esc_launch_plan(*ops, row_cap=row_cap)
    assert launches == plan.launch_order
    for order in ORDERS:
        assert esc.kernels_per_call(order, len(r0s), plan) == len(launches) + 2
        want = esc.sparse_accum_plain(*ops[:3], r0s, r1s, order=order)
        for x, y in zip(got, want):
            assert torch.equal(x, y), order
    return plan


@pytest.mark.parametrize("with_c0", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_classed_emulation_matches_plain_on_the_corpus(monkeypatch, case, with_c0):
    _, (Ast, Bst, C0st), (r0s, r1s), row_cap = stage_csr_case(case)
    C0st = C0st if with_c0 else empty_c0(C0st)
    classed(monkeypatch, (1, 2, 4, 8))
    plan = assert_emulation_matches_plain((Ast, Bst, C0st, r0s, r1s), row_cap)
    assert plan.split


def rmat9(with_c0: bool):
    """L x L of rmat(9, 16, seed 3), ``plan_knl`` at a third of L's row
    bytes; C_prev L's strips or none."""
    from repro_torch.core import chunk_stream, chunking, planner, symbolic
    from repro_torch.sparse import graphs
    from repro_torch.sparse.csr import csr_pad_to, csr_stack

    L = graphs.lower_triangular_degree_sorted(graphs.rmat(9, 16, seed=3, device="cpu"))
    plan = planner.plan_knl(L, L, float(planner.row_bytes_csr(L).sum()) / 3)
    caps = symbolic.strip_output_caps(L, L, plan.p_ac)
    strips = chunking.a_strips(L, plan.p_ac)
    Ast = csr_stack([csr_stack(strips)])
    Bst = csr_stack([csr_stack(chunking.b_chunks(L, plan.p_b))])
    if with_c0:
        # C_prev = L's own strips: every output row the union of both
        c_cap = caps.c_pad + max(s.nnz_pad for s in strips)
        row_cap = caps.c_max_row_nnz + L.max_row_nnz
        C0 = csr_stack([csr_stack([csr_pad_to(s, c_cap, max_row_nnz=c_cap)
                                   for s in strips])])
    else:
        row_cap = caps.c_max_row_nnz
        C0 = chunk_stream._sparse_c0_stack(1, plan.n_ac, strips[0].n_rows, L.n_cols,
                                           caps.c_pad, L.dtype, "cpu")
    r0s, r1s = plan.b_ranges()
    return (Ast, Bst, C0, r0s, r1s), row_cap


@pytest.mark.parametrize("with_c0", [True, False])
def test_classed_emulation_matches_plain_on_rmat(monkeypatch, with_c0):
    ops, row_cap = rmat9(with_c0)
    classed(monkeypatch, (4, 16, 64, 256))
    plan = assert_emulation_matches_plain(ops, row_cap)
    assert min(plan.routes.values()) > 0, plan.routes
    assert int((plan.offsets[1:] - plan.offsets[:-1]).max()) >= 4 * 256   # 3+ global passes


@pytest.mark.parametrize("n_cols, bits", [(None, 32), ((1 << 30) + 9, 64)])
def test_class_edge_rows_land_on_every_edge(monkeypatch, n_cols, bits):
    """``chip_smoke.py``'s class-edge rows at small cuts: steps of W and
    W + 1 keys at every cut, every class taken, and the classed launch
    emulated equal to the plain version, with the block and global keys in
    32 bits (narrow columns) or 64 (2^30 + 9 columns)."""
    import chip_smoke

    cuts = (4, 8, 16, 32)
    classed(monkeypatch, cuts)
    Ast, Bst, C0, plan, row_cap, _ = chip_smoke.Smoke(torch).class_edge_geometry(
        80, n_cols, device="cpu")
    r0s, r1s = plan.b_ranges()
    keys = esc.step_keys(Ast, Bst, C0, r0s, r1s)
    for w in cuts:
        assert int((keys == w).sum()) and int((keys == w + 1).sum()), w
    launch = assert_emulation_matches_plain((Ast, Bst, C0, r0s, r1s), row_cap)
    assert min(launch.routes.values()) > 0, launch.routes
    assert {launch.key_layout(c)[0] for c in launch.classes if c.kind != "warp"} == {bits}


@pytest.mark.parametrize("n_cols, slots, want", [
    (4_096, 2_048, (32, 11)), (1 << 18, 16_384, (32, 14)), ((1 << 18) + 1, 16_384, (64, 32)),
    (1 << 20, 2_048, (32, 11)), (1 << 20, 16_384, (64, 32))])
def test_block_keys_pack_32_bits_where_columns_and_slots_fit(n_cols, slots, want):
    """A block class's keys: ``key_bits`` of the call's width and the
    class's ``W``; the global class's: of the width and the call's largest
    global step."""
    classes = esc.step_classes(100)
    block = next(c for c in classes if c.kind == "block" and c.max_keys == slots)
    plan = esc.EscLaunch(classes=classes, n_cols=n_cols,
                         offsets=torch.tensor([0, 8, 8 + slots]))
    assert plan.key_layout(block) == want
    assert plan.key_layout(classes[-1]) == want


@pytest.mark.parametrize("tile", [2, 8, 256, 16_384])
def test_tiled_sort_sorts_every_power_of_two(tile):
    rng = np.random.default_rng(tile)
    for m in range(1, 17):
        n2 = 1 << m
        keys = rng.choice(1 << 40, n2, replace=False).astype(np.uint64) << np.uint64(20)
        keys[rng.random(n2) < 0.2] = np.iinfo(np.uint64).max   # padding slots
        keys = np.unique(keys)
        keys = np.concatenate([keys, np.full(n2 - keys.size, np.iinfo(np.uint64).max,
                                             np.uint64)])
        rng.shuffle(keys)
        passes = []
        got = tiled_network(keys, tile, passes)
        assert np.array_equal(got, np.sort(keys)), (n2, tile)
        tiles = max(n2 // tile, 1).bit_length() - 1
        assert len(passes) == tiles * (tiles + 1) // 2
        assert all(jj >= tile for _, jj in passes)


def test_a_32768_slot_step_takes_one_global_pass():
    passes = []
    keys = np.random.default_rng(0).permutation(32_768).astype(np.uint64)
    assert np.array_equal(tiled_network(keys, 16_384, passes), np.arange(32_768))
    assert passes == [(32_768, 16_384)]


def test_rmat12_plan_reproduces_the_step_table():
    """Counted with the port's own ``step_keys``: 16,384 steps (4 chunks x
    4,096 rows), 12,280 empty, 2,901,220 keys, 16 past 16,384 keys."""
    ops, row_cap, _, launch = rmat12_plan()
    keys = esc.step_keys(*ops).flatten()
    assert row_cap == 3_253 and keys.numel() == 16_384 and int(keys.sum()) == 2_901_220
    table = {}
    for lo, hi in ((0, 1), (1, 32), (32, 128), (128, 512), (512, 2_048), (2_048, 8_192),
                   (8_192, 16_384), (16_384, 1 << 30)):
        band = keys[(keys >= lo) & (keys < hi)]
        table[lo] = (band.numel(), int(band.sum()))
    assert table == {0: (12_280, 0), 1: (1_920, 15_144), 32: (902, 59_923),
                     128: (270, 79_110), 512: (657, 693_842), 2_048: (272, 980_409),
                     8_192: (67, 793_264), 16_384: (16, 279_528)}
    assert int(keys.max()) == 18_544
    assert launch.routes == {"empty": 12_280, "warp128": 2_824, "block512": 271,
                             "block2048": 654, "block16384": 339, "global": 16}
