"""The ESC merge's two routes (``kernels/sparse_accum_spgemm.py``,
``csrc/sparse_accum_spgemm.cu``) on the CPU, where no kernel runs.

* ``step_keys`` counts every (strip row, chunk) merge step's keys exactly as
  ``plain_steps`` does from the plain version's own steps.
* ``esc_launch_plan`` routes each step by its own key count: at a
  monkeypatched small ``SMEM_PER_BLOCK`` the steps past ``shared_max_keys``
  take the global route, the shared route is sized by the largest step that
  fits, the global steps' sort slots are an exclusive scan of their next
  powers of two, and the counts agree with ``sort_steps``.
* :func:`esc_split_emulated` follows a split call chunk by chunk as the
  kernels run it: the shared merge (a warp's load-balanced expand) for the
  rows whose step fits, the global merge (a block's expand over tiles of 512
  A entries, 64-bit keys ``column << 32 | position`` sorted by the bitonic
  network over the step's next power of two of slots, the compress from
  0.0f) for the others, each row's accumulator in its slab between them. It
  must equal ``sparse_accum_plain`` bit for bit and the JAX
  ``sparse_accum_spgemm_stream`` (interpret mode) within atol 1e-4, on the
  audit corpus's ``dense_row`` and ``skewed_rows`` cases, in both orders.
* The launch plan of L x L of an RMAT scale-12 graph, whose launch-wide
  bound is 25.2 MB of shared memory a row, no longer raises.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro.analysis import corpus as ref_corpus
from repro_torch.kernels import sparse_accum_spgemm as esc
from test_torch_spgemm_redesign import (
    assert_plain_equal, assert_reference_close, load_balanced_products, shared_network,
    stage_dense,
)

ORDERS = ("chunk1", "chunk2")
GLOBAL_THREADS = 512


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def corpus_operands(case: str, c0_seed: int | None):
    """The audit corpus case's dense (A, B) cut in thirds, with an empty or
    a random C_prev, staged for both packages."""
    builder, seed = ref_corpus.CASES[case]
    a, b = builder(seed)
    c0 = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if c0_seed is not None:
        rng = np.random.default_rng(c0_seed)
        c0 = np.where(rng.random(c0.shape) < 0.15, rng.standard_normal(c0.shape),
                      0).astype(np.float32)

    def thirds(n):
        return (0, n) if n < 3 else (0, n // 3, 2 * n // 3, n)
    return stage_dense(a, b, c0, thirds(a.shape[0]), thirds(a.shape[1]))


def global_products(a_cols, a_vals, b_ip, b_ix, b_d, r0, r1, b_mrn, chunk_rows, chunk_cap):
    """A row's in-range products as the global route's block finds them:
    per tile of 512 A entries the exclusive scan of their product counts,
    then product q of the tile (thread q % 512) from its entry, the last
    whose scan is <= q (the kernel's binary search over the 512 slots)."""
    cols, vals = [], []
    for base in range(0, len(a_cols), GLOBAL_THREADS):
        cnt = np.zeros(GLOBAL_THREADS, np.int64)
        start = np.zeros(GLOBAL_THREADS, np.int64)
        a_val = np.zeros(GLOBAL_THREADS, np.float32)
        for t, (col, val) in enumerate(zip(a_cols[base:base + GLOBAL_THREADS],
                                           a_vals[base:base + GLOBAL_THREADS])):
            if r0 <= col < r1:
                b_row = min(max(col - r0, 0), chunk_rows - 1)
                start[t] = b_ip[b_row]
                cnt[t] = max(min(b_ip[b_row + 1] - start[t], b_mrn), 0)
                a_val[t] = val
        excl = np.cumsum(cnt) - cnt
        for q in range(int(cnt.sum())):
            lo = 0
            step = GLOBAL_THREADS // 2
            while step:
                if excl[lo + step] <= q:
                    lo += step
                step //= 2
            assert excl[lo] <= q < excl[lo] + cnt[lo]
            src = min(start[lo] + q - excl[lo], chunk_cap - 1)
            cols.append(int(b_ix[src]))
            vals.append(np.float32(a_val[lo] * np.float32(b_d[src])))
    return cols, vals


def merge_step(cols, vals, acc_cols, acc_vals):
    """Sort keys ``column << 32 | position`` (the bitonic network over the
    next power of two of slots, padded with ~0) and compress: each run of a
    column summed in sorted order from 0.0f."""
    n = len(cols) + len(acc_cols)
    if n == 0:
        return [], []
    all_cols = np.asarray(list(cols) + list(acc_cols), np.uint64)
    all_vals = np.asarray(list(vals) + list(acc_vals), np.float32)
    keys = np.full(_pow2(n), np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = (all_cols << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    keys = shared_network(keys)[:n]
    out_c, out_v = [], []
    for key in keys:
        col = int(key >> np.uint64(32))
        val = all_vals[int(key & np.uint64(0xFFFFFFFF))]
        if out_c and out_c[-1] == col:
            out_v[-1] = np.float32(out_v[-1] + val)
        else:
            out_c.append(col)
            out_v.append(np.float32(np.float32(0.0) + val))
    return out_c, out_v


def esc_split_emulated(Ast, Bst, C0st, r0s, r1s, *, row_cap):
    """One ESC call with every step routed by ``esc_launch_plan``, chunk by
    chunk as the split launch runs it (the shared merge, then the global
    merge of the chunk's global steps), then the scan and the copy. Returns
    the stacked triple and the routes taken (step counts)."""
    g = esc.stack_geometry(Ast, Bst, C0st, "chunk1")
    plan = esc.esc_launch_plan(Ast, Bst, C0st, r0s, r1s, row_cap=row_cap)
    assert plan.split
    batch, n_ac, n_b, R = g["batch"], g["n_ac"], g["n_b"], g["strip_rows"]
    skip = plan.skip.numpy().astype(bool)
    a_ip, a_ix, a_d = (t.numpy() for t in (Ast.indptr, Ast.indices, Ast.data))
    b_ip, b_ix, b_d = (t.numpy() for t in (Bst.indptr, Bst.indices, Bst.data))
    c_ip, c_ix, c_d = (t.numpy() for t in (C0st.indptr, C0st.indices, C0st.data))
    slab = {}
    taken = {"shared": 0, "global": 0}
    for j in range(n_b):
        for b in range(batch):
            for i in range(n_ac):
                for r in range(R):
                    row = (b * n_ac + i) * R + r
                    if j == 0:
                        s, e = c_ip[b, i, r], c_ip[b, i, r + 1]
                        acc = (list(c_ix[b, i, s:e]), list(c_d[b, i, s:e]))
                    else:
                        acc = slab[row]
                    s, e = a_ip[b, i, r], a_ip[b, i, r + 1]
                    expand = global_products if skip[j, row] else load_balanced_products
                    cols, vals = expand(a_ix[b, i, s:e], a_d[b, i, s:e], b_ip[b, j],
                                        b_ix[b, j], b_d[b, j], int(r0s[j]), int(r1s[j]),
                                        Bst.max_row_nnz, g["chunk_rows"], g["chunk_cap"])
                    keys = len(cols) + len(acc[0])
                    if skip[j, row]:
                        taken["global"] += 1
                        assert keys > plan.shared_max_keys or not plan.shared_max_keys
                        k = int(np.searchsorted(plan.items.numpy()[
                            plan.chunk_items[j]:plan.chunk_items[j + 1]], row)) \
                            + plan.chunk_items[j]
                        assert plan.items[k] == row
                        slots = int(plan.offsets[k + 1] - plan.offsets[k])
                        assert slots == _pow2(keys)
                    else:
                        taken["shared"] += 1
                        assert keys <= plan.work_cap
                    slab[row] = merge_step(cols, vals, *acc)
                    assert len(slab[row][0]) <= row_cap
    out_ip = np.zeros_like(c_ip)
    out_ix = np.zeros_like(c_ix)
    out_d = np.zeros_like(c_d)
    for b in range(batch):
        for i in range(n_ac):
            pos = 0
            for r in range(R):
                cols, vals = slab[(b * n_ac + i) * R + r]
                out_ip[b, i, r] = pos
                out_ix[b, i, pos:pos + len(cols)] = cols
                out_d[b, i, pos:pos + len(cols)] = vals
                pos += len(cols)
            out_ip[b, i, R] = pos
    return tuple(torch.from_numpy(x) for x in (out_ip, out_ix, out_d)), taken


def smem_for(row_cap: int, keys: int) -> int:
    """A block's shared memory where ``keys`` is the most a shared step holds."""
    return keys * 12 + row_cap * 8 + 16


@pytest.mark.parametrize("case, c0_seed", [("dense_row", None), ("skewed_rows", None),
                                           ("dense_row", 5), ("skewed_rows", 6)])
def test_step_keys_equal_the_plain_steps(case, c0_seed):
    _, port, (r0s, r1s), _ = corpus_operands(case, c0_seed)
    keys = esc.step_keys(*port, r0s, r1s)
    steps = 0
    for b, i, j, n, _ in esc.plain_steps(*port, r0s, r1s):
        assert torch.equal(keys[b, i, j], n), (b, i, j)
        steps += n.numel()
    assert keys.numel() == steps


@pytest.mark.parametrize("shared_keys", [2, 4, 8])
@pytest.mark.parametrize("case", ["dense_row", "skewed_rows"])
def test_classifier_routes_each_step_by_its_keys(monkeypatch, case, shared_keys):
    _, port, (r0s, r1s), row_cap = corpus_operands(case, 7)
    monkeypatch.setattr(esc, "SMEM_PER_BLOCK", smem_for(row_cap, shared_keys))
    assert esc.shared_max_keys(row_cap) == shared_keys
    plan = esc.esc_launch_plan(*port, r0s, r1s, row_cap=row_cap)
    counts = [(j, int(n[r])) for _, _, j, n, _ in esc.plain_steps(*port, r0s, r1s)
              for r in range(n.numel())]
    over = [n for _, n in counts if n > shared_keys]
    fit = [n for _, n in counts if n <= shared_keys]
    assert plan.split and plan.routes == {"shared": len(fit), "global": len(over)}
    assert plan.work_cap == _pow2(max(max(fit), 1))
    assert plan.smem_per_warp <= esc.SMEM_PER_BLOCK
    assert int(plan.skip.sum()) == len(over) == plan.items.numel()
    slots = (plan.offsets[1:] - plan.offsets[:-1]).tolist()
    assert sorted(slots) == sorted(_pow2(n) for n in over)
    assert plan.workspace_bytes == 12 * sum(slots)
    n_b = len(r0s)
    assert plan.chunk_items == tuple(
        sum(1 for j, n in counts if n > shared_keys and j < c) for c in range(n_b + 1))
    steps = esc.sort_steps(*port, r0s, r1s, row_cap=row_cap)
    assert steps.get("global/64", 0) == plan.routes["global"]
    assert sum(v for k, v in steps.items() if k != "global/64") == plan.routes["shared"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shared_keys", [0, 4])
@pytest.mark.parametrize("case, c0_seed", [("dense_row", 11), ("skewed_rows", None)])
def test_split_emulation_matches_plain_and_reference(monkeypatch, case, c0_seed, shared_keys,
                                                     order):
    """Every step global (no shared route fits), or the two routes mixed."""
    ref, port, (r0s, r1s), row_cap = corpus_operands(case, c0_seed)
    monkeypatch.setattr(esc, "SMEM_PER_BLOCK",
                        smem_for(row_cap, shared_keys) if shared_keys else row_cap * 8)
    got, taken = esc_split_emulated(*port, r0s, r1s, row_cap=row_cap)
    assert taken["global"] > 0
    assert (taken["shared"] > 0) == bool(shared_keys)
    # both orders run each row's steps in the same sequence, so one
    # emulation stands for both; the plain version and the reference run
    # the given order
    want = esc.sparse_accum_plain(*port, r0s, r1s, order=order)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert_plain_equal(got, *port, r0s, r1s)
    assert_reference_close(got, ref, r0s, r1s)


def test_launch_plan_of_rmat12_l_times_l_no_longer_raises():
    """L x L of an RMAT scale-12 graph: the launch-wide bound is 2^21 keys,
    25.2 MB of shared memory a row; the steps routed by their own keys fit
    the shared route but for a few rows, which take the global route."""
    from repro_torch.core import chunk_stream, chunking, planner, symbolic
    from repro_torch.sparse import graphs
    from repro_torch.sparse.csr import csr_stack

    L = graphs.lower_triangular_degree_sorted(graphs.rmat(12, 16, seed=100, device="cpu"))
    plan = planner.plan_knl(L, L, float(planner.row_bytes_csr(L).sum()) / 3)
    caps = symbolic.strip_output_caps(L, L, plan.p_ac)
    strips, chunks = chunking.a_strips(L, plan.p_ac), chunking.b_chunks(L, plan.p_b)
    Ast, Bst = csr_stack([csr_stack(strips)]), csr_stack([csr_stack(chunks)])
    C0 = chunk_stream._sparse_c0_stack(1, plan.n_ac, strips[0].n_rows, L.n_cols,
                                       caps.c_pad, L.dtype, "cpu")
    r0s, r1s = plan.b_ranges()
    row_cap = caps.c_max_row_nnz
    _, bound = esc.esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
    assert bound > 25_000_000 > esc.SMEM_PER_BLOCK
    launch = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
    assert launch.split and launch.smem_per_warp <= esc.SMEM_PER_BLOCK
    assert launch.work_cap == launch.shared_max_keys == 16384
    assert 0 < launch.routes["global"] < launch.routes["shared"]
    assert launch.workspace_bytes < 64 << 20
    assert esc.kernels_per_call("chunk1", plan.n_b, launch) == (
        sum(launch.shared_chunks) + sum(int(a < b) for a, b in
                                        zip(launch.chunk_items[:-1],
                                            launch.chunk_items[1:])) + 2)


def test_unsplit_plans_keep_the_launch_wide_bound():
    """Where the bound fits, no step is counted: the shared route at the
    bound, one merge launch (chunk1) or one a chunk (chunk2)."""
    _, port, (r0s, r1s), row_cap = corpus_operands("skewed_rows", None)
    plan = esc.esc_launch_plan(*port, r0s, r1s, row_cap=row_cap)
    work_cap, smem = esc.esc_workspace(port[0].max_row_nnz, port[1].max_row_nnz, row_cap)
    assert (plan.work_cap, plan.smem_per_warp, plan.split, plan.routes) == (
        work_cap, smem, False, None)
    assert esc.kernels_per_call("chunk2", len(r0s), plan) == len(r0s) + 2


def test_hash_merge_guard_fires_past_16384_entries_a_row():
    """The hash merge keeps a row's table in shared memory through the same
    launch helper: 8 bytes a slot, so the largest table is 16,384 slots
    (c_max_row_nnz <= 16,384); a table of 32,768 slots is refused before
    any launch."""
    from repro_torch.core.planner import hash_table_slots

    assert hash_table_slots(16_384) * 8 <= esc.SMEM_PER_BLOCK
    assert hash_table_slots(16_385) * 8 > esc.SMEM_PER_BLOCK
    _, port, (r0s, r1s), _ = corpus_operands("skewed_rows", None)
    with pytest.raises(ValueError, match="shared memory"):
        esc.launch_csr_accum("hash_accum_spgemm", "hash_accum_launch", esc.LAUNCHES, *port,
                             r0s, r1s, order="chunk1", row_cap=32_768, work_cap=0,
                             smem_per_warp=32_768 * 8)
