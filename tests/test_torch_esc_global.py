"""The ESC merge's counted calls (``kernels/sparse_accum_spgemm.py``,
``csrc/sparse_accum_spgemm.cu``) on the CPU, where no kernel runs.

* ``step_keys`` counts every (strip row, chunk) merge step's keys exactly as
  ``plain_steps`` does from the plain version's own steps.
* ``esc_launch_plan`` classes each step by its own key count: at
  monkeypatched small class cuts (:func:`classed`: a launch-wide bound past
  a block's shared memory, so the steps are counted) each non-empty step
  is listed once, under the first class its keys fit, the global class's
  sort slots are an exclusive scan of their next powers of two, and the
  counts agree with ``sort_steps``.
* :func:`esc_classed_emulated` follows a classed call chunk by chunk as the
  kernels run it: per class, a warp's merge (load-balanced expand, the sort
  of ``sort_class`` at the class's ``work_cap``, the compress), a block's
  (expand over tiles of its threads' A entries, 64-bit keys ``column << 32 |
  position`` sorted by the bitonic network over the step's next power of two
  of slots, the compress from 0.0f) or the global class's (the same, sorted
  in tiles, :func:`tiled_network`), each row's accumulator in its slab
  between chunks, nothing for an empty step. It must equal
  ``sparse_accum_plain`` bit for bit and the JAX
  ``sparse_accum_spgemm_stream`` (interpret mode) within atol 1e-4, on the
  audit corpus's ``dense_row`` and ``skewed_rows`` cases, in both orders
  (block and global keys in 32 bits there; :func:`merge_step` also packs
  64-bit ones, which the class tests take at a width of 2^25 + 9 columns).
* The launch plan of L x L of an RMAT scale-12 graph, whose launch-wide
  bound is 25.2 MB of shared memory a row, is classed and fits.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro.analysis import corpus as ref_corpus
from repro_torch.kernels import sparse_accum_spgemm as esc
from test_torch_spgemm_redesign import (
    assert_plain_equal, assert_reference_close, compress, compress_registers,
    load_balanced_products, shared_network, sort_keys, stage_dense,
)

ORDERS = ("chunk1", "chunk2")
# small class cuts (each class's most keys) for the corpus's small steps
SMALL_CUTS = ((2, 4, 8, 16), (1, 2, 4, 8), (4, 8, 16, 32))


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def classed(monkeypatch, cuts) -> None:
    """Count the steps of every call (a launch-wide bound one byte past a
    block's shared memory) and class them at ``cuts``, the most keys of
    each of ``STEP_CLASSES`` in turn."""
    bound = esc.esc_workspace
    monkeypatch.setattr(esc, "esc_workspace",
                        lambda *a: (bound(*a)[0], esc.SMEM_PER_BLOCK + 1))
    monkeypatch.setattr(esc, "STEP_CLASSES", tuple(
        (name, kind, w) for (name, kind, _), w in zip(esc.STEP_CLASSES, cuts)))


def block_network(tiles, base, k_first: int, k_last: int):
    """``block_bitonic`` on each row of ``tiles`` (a tile of a power of two
    of keys, slots ``base[row] + t`` of the whole sort): stages k_first ...
    k_last, of each the sub-stages of stride below the tile."""
    n = tiles.shape[1]
    i = np.arange(n // 2)
    k = k_first
    while k <= k_last:
        jj = min(k, n) // 2
        while jj > 0:
            t = ((i & ~(jj - 1)) << 1) | (i & (jj - 1))
            u = t | jj
            up = ((base[:, None] + t) & k) == 0
            x, y = tiles[:, t].copy(), tiles[:, u].copy()
            swap = (x > y) == up
            tiles[:, t] = np.where(swap, y, x)
            tiles[:, u] = np.where(swap, x, y)
            jj //= 2
        k *= 2


def tiled_network(keys, tile: int, passes: list | None = None):
    """``esc_global_kernel``'s sort of a power of two of keys: each tile (of
    ``tile`` keys, or all of them) sorted in shared memory, then for each
    wider stage the sub-stages of stride at least a tile over the whole
    array (a global pass, appended to ``passes`` as ``(k, jj)``) and the
    rest on each tile."""
    keys = keys.copy()
    n2 = keys.size
    length = min(tile, n2)
    tiles = keys.reshape(-1, length)          # a view: writes reach keys
    base = np.arange(tiles.shape[0]) * length
    block_network(tiles, base, 2, length)
    i = np.arange(n2 // 2)
    k = 2 * length
    while k <= n2:
        jj = k // 2
        while jj >= length:
            t = ((i & ~(jj - 1)) << 1) | (i & (jj - 1))
            u = t | jj
            x, y = keys[t].copy(), keys[u].copy()
            swap = (x > y) == ((t & k) == 0)
            keys[t] = np.where(swap, y, x)
            keys[u] = np.where(swap, x, y)
            if passes is not None:
                passes.append((k, jj))
            jj //= 2
        block_network(tiles, base, k, k)
        k *= 2
    return keys


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


def block_products(a_cols, a_vals, b_ip, b_ix, b_d, r0, r1, b_mrn, chunk_rows, chunk_cap,
                   threads=esc.BLOCK_THREADS):
    """A row's in-range products as a block of ``threads`` threads finds
    them (``block_expand``): per tile of ``threads`` A entries the exclusive
    scan of their product counts, then product q of the tile (thread q %
    threads) from its entry, the last whose scan is <= q (the kernel's
    binary search over the tile's slots)."""
    cols, vals = [], []
    for base in range(0, len(a_cols), threads):
        cnt = np.zeros(threads, np.int64)
        start = np.zeros(threads, np.int64)
        a_val = np.zeros(threads, np.float32)
        for t, (col, val) in enumerate(zip(a_cols[base:base + threads],
                                           a_vals[base:base + threads])):
            if r0 <= col < r1:
                b_row = min(max(col - r0, 0), chunk_rows - 1)
                start[t] = b_ip[b_row]
                cnt[t] = max(min(b_ip[b_row + 1] - start[t], b_mrn), 0)
                a_val[t] = val
        excl = np.cumsum(cnt) - cnt
        for q in range(int(cnt.sum())):
            lo = 0
            step = threads // 2
            while step:
                if excl[lo + step] <= q:
                    lo += step
                step //= 2
            assert excl[lo] <= q < excl[lo] + cnt[lo]
            src = min(start[lo] + q - excl[lo], chunk_cap - 1)
            cols.append(int(b_ix[src]))
            vals.append(np.float32(a_val[lo] * np.float32(b_d[src])))
    return cols, vals


def merge_step(cols, vals, acc_cols, acc_vals, network=shared_network, layout=(64, 32)):
    """Sort keys ``column << shift | position`` (``layout``: key bits and
    shift; ``network`` over the next power of two of slots, padded with ~0)
    and compress: each run of a column summed in sorted order from 0.0f."""
    n = len(cols) + len(acc_cols)
    if n == 0:
        return [], []
    dtype = np.uint32 if layout[0] == 32 else np.uint64
    shift = np.uint64(layout[1])
    all_cols = np.asarray(list(cols) + list(acc_cols), np.uint64)
    all_vals = np.asarray(list(vals) + list(acc_vals), np.float32)
    packed = (all_cols << shift) | np.arange(n, dtype=np.uint64)
    assert int(packed.max()) < np.iinfo(dtype).max
    keys = np.full(_pow2(n), np.iinfo(dtype).max, dtype)
    keys[:n] = packed.astype(dtype)
    keys = network(keys)[:n].astype(np.uint64)
    out_c, out_v = [], []
    for key in keys:
        col = int(key >> shift)
        val = all_vals[int(key & ((np.uint64(1) << shift) - np.uint64(1)))]
        if out_c and out_c[-1] == col:
            out_v[-1] = np.float32(out_v[-1] + val)
        else:
            out_c.append(col)
            out_v.append(np.float32(np.float32(0.0) + val))
    return out_c, out_v


def warp_merge(cols, vals, acc_cols, acc_vals, work_cap: int):
    """A warp class's merge (``EscMerge`` at the class's ``work_cap``): the
    sort of the step's size class and key width, then the compress (from
    the registers after a register sort)."""
    all_cols = list(cols) + [int(c) for c in acc_cols]
    all_vals = np.asarray(list(vals) + list(acc_vals), np.float32)
    keys, shift, _ = sort_keys(all_cols, work_cap)
    if keys.ndim == 1:
        return compress(keys, shift, all_vals)
    return compress_registers(keys, len(all_cols), shift, all_vals)


def esc_classed_emulated(Ast, Bst, C0st, r0s, r1s, *, row_cap):
    """One ESC call launched by step class (``esc_launch_plan``), chunk by
    chunk as the kernels run it (every slab count zeroed first; per chunk
    each class with steps there over its own rows), then the scan and the
    copy. Returns the stacked triple and the class of each merge launch in
    launch order."""
    g = esc.stack_geometry(Ast, Bst, C0st, "chunk1")
    plan = esc.esc_launch_plan(Ast, Bst, C0st, r0s, r1s, row_cap=row_cap)
    assert plan.split
    batch, n_ac, n_b, R = g["batch"], g["n_ac"], g["n_b"], g["strip_rows"]
    keys = esc.step_keys(Ast, Bst, C0st, r0s, r1s).permute(2, 0, 1, 3).reshape(n_b, -1)
    a_ip, a_ix, a_d = (t.numpy() for t in (Ast.indptr, Ast.indices, Ast.data))
    b_ip, b_ix, b_d = (t.numpy() for t in (Bst.indptr, Bst.indices, Bst.data))
    c_ip, c_ix, c_d = (t.numpy() for t in (C0st.indptr, C0st.indices, C0st.data))
    items, offsets = plan.items.numpy(), plan.offsets.numpy()
    n_cls = len(plan.classes)
    slab = {row: ([], []) for row in range(batch * n_ac * R)}
    launches, global_seen = [], 0

    def operands(row, j):
        b, i, r = row // (n_ac * R), row // R % n_ac, row % R
        if j == 0:
            s, e = c_ip[b, i, r], c_ip[b, i, r + 1]
            acc = (list(c_ix[b, i, s:e]), list(c_d[b, i, s:e]))
        else:
            acc = slab[row]
        s, e = a_ip[b, i, r], a_ip[b, i, r + 1]
        return acc, (a_ix[b, i, s:e], a_d[b, i, s:e], b_ip[b, j], b_ix[b, j], b_d[b, j],
                     int(r0s[j]), int(r1s[j]), Bst.max_row_nnz, g["chunk_rows"],
                     g["chunk_cap"])

    for j in range(n_b):
        stepped = set()
        for ci, c in enumerate(plan.classes):
            first, last = plan.starts[j * n_cls + ci], plan.starts[j * n_cls + ci + 1]
            if first == last:
                continue
            launches.append(c.name)
            below = plan.classes[ci - 1].max_keys if ci else 0
            for k in range(first, last):
                row = int(items[k])
                assert row not in stepped
                stepped.add(row)
                acc, ops = operands(row, j)
                if c.kind == "warp":
                    cols, vals = load_balanced_products(*ops)
                else:
                    cols, vals = block_products(*ops, threads=c.threads)
                n = len(cols) + len(acc[0])
                assert n == int(keys[j, row]) and below < n <= c.max_keys, (c.name, n)
                if c.kind == "warp":
                    assert len(acc[0]) <= c.acc_cap
                    slab[row] = warp_merge(cols, vals, *acc, c.work_cap)
                elif c.kind == "block":
                    slab[row] = merge_step(cols, vals, *acc, layout=plan.key_layout(c))
                else:
                    slots = int(offsets[global_seen + 1] - offsets[global_seen])
                    assert slots == _pow2(n)
                    global_seen += 1
                    slab[row] = merge_step(cols, vals, *acc, layout=plan.key_layout(c),
                                           network=lambda x: tiled_network(x, c.work_cap))
                assert len(slab[row][0]) <= row_cap
        for row in set(slab) - stepped:   # an empty step: nothing launched
            acc, ops = operands(row, j)
            assert not acc[0] and not load_balanced_products(*ops)[0]
    assert global_seen == len(offsets) - 1
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
    return tuple(torch.from_numpy(x) for x in (out_ip, out_ix, out_d)), launches


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


@pytest.mark.parametrize("cuts", SMALL_CUTS)
@pytest.mark.parametrize("case", ["dense_row", "skewed_rows"])
def test_classifier_routes_each_step_by_its_keys(monkeypatch, case, cuts):
    _, port, (r0s, r1s), row_cap = corpus_operands(case, 7)
    classed(monkeypatch, cuts)
    plan = esc.esc_launch_plan(*port, r0s, r1s, row_cap=row_cap)
    counts = [(j, int(n[r])) for _, _, j, n, _ in esc.plain_steps(*port, r0s, r1s)
              for r in range(n.numel())]
    assert plan.split and [c.max_keys for c in plan.classes[:-1]] == list(cuts)

    def class_of(n):
        return next(i for i, c in enumerate(plan.classes) if n <= c.max_keys)
    want = {c.name: sum(1 for _, n in counts if n and class_of(n) == i)
            for i, c in enumerate(plan.classes)}
    assert plan.routes == {"empty": sum(1 for _, n in counts if not n), **want}
    assert plan.items.numel() == sum(want.values())
    over = [n for _, n in counts if n > cuts[-1]]
    slots = (plan.offsets[1:] - plan.offsets[:-1]).tolist()
    assert sorted(slots) == sorted(_pow2(n) for n in over)
    assert plan.workspace_bytes == 12 * sum(slots)
    n_b, n_cls = len(r0s), len(plan.classes)
    assert plan.starts[-1] == plan.items.numel()
    for j in range(n_b):
        for i in range(n_cls):
            assert plan.starts[j * n_cls + i + 1] - plan.starts[j * n_cls + i] == sum(
                1 for jj, n in counts if jj == j and n and class_of(n) == i)
    steps = esc.sort_steps(*port, r0s, r1s, row_cap=row_cap)
    assert steps.get("none", 0) == plan.routes["empty"]
    for c in plan.classes:
        assert sum(v for k, v in steps.items() if k.split("/")[0] == c.name) == want[c.name]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("cuts", SMALL_CUTS[:2])
@pytest.mark.parametrize("case, c0_seed", [("dense_row", 11), ("skewed_rows", None)])
def test_split_emulation_matches_plain_and_reference(monkeypatch, case, c0_seed, cuts, order):
    """Every class, the global one included, takes steps."""
    ref, port, (r0s, r1s), row_cap = corpus_operands(case, c0_seed)
    classed(monkeypatch, cuts)
    got, launches = esc_classed_emulated(*port, r0s, r1s, row_cap=row_cap)
    plan = esc.esc_launch_plan(*port, r0s, r1s, row_cap=row_cap)
    assert "global" in launches and launches == plan.launch_order
    assert esc.kernels_per_call(order, len(r0s), plan) == len(launches) + 2
    # both orders run each row's steps in the same sequence, so one
    # emulation stands for both; the plain version and the reference run
    # the given order
    want = esc.sparse_accum_plain(*port, r0s, r1s, order=order)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert_plain_equal(got, *port, r0s, r1s)
    assert_reference_close(got, ref, r0s, r1s)


def rmat12_plan():
    """L x L of rmat(12, 16, seed 100) staged as chip_smoke.py stages it
    (``plan_knl`` at a third of L's row bytes), and its ESC launch plan."""
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
    ops = (Ast, Bst, C0, r0s, r1s)
    return ops, caps.c_max_row_nnz, plan, esc.esc_launch_plan(*ops, row_cap=caps.c_max_row_nnz)


def test_launch_plan_of_rmat12_l_times_l_no_longer_raises():
    """L x L of an RMAT scale-12 graph: the launch-wide bound is 2^21 keys,
    25.2 MB of shared memory a row; counted, the steps take every class,
    the 16 largest the global one, and each class's block fits."""
    (Ast, Bst, *_), row_cap, plan, launch = rmat12_plan()
    _, bound = esc.esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
    assert bound > 25_000_000 > esc.SMEM_PER_BLOCK
    assert launch.split and all(c.block_smem <= esc.SMEM_PER_BLOCK for c in launch.classes)
    assert launch.routes["global"] == 16 and min(launch.routes.values()) > 0
    assert launch.workspace_bytes < 64 << 20
    assert launch.launches == {"warp128": 4, "block512": 4, "block2048": 4, "block16384": 4,
                               "global": 2}
    assert esc.kernels_per_call("chunk1", plan.n_b, launch) == 20


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
