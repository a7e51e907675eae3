"""The two hash kernels as their CUDA kernels compute them, emulated step by
step on the CPU (no kernel runs here).

* The masked kernel (``csrc/hash_masked_accum_spgemm.cu``): the work list
  (``masked_work``) covers every A entry of every masked row exactly once,
  cuts no part above the part size unless it is a single A entry, comes
  heaviest first and leaves empty mask rows out; ``masked_launches`` groups
  the parts by team and table. :func:`masked_emulated` follows the
  kernel's split-and-add: per part its own table seeded from the mask row
  (a global row's parts share one table, gathered after the last launch),
  C_prev added once by the row's first part, products probe-only, sums
  added at the mask positions (stored by a row's only part), chunk2's later
  launches adding onto the output. It is held to ``hash_masked_plain``
  (structure exact, values atol 1e-5) and to the JAX
  ``hash_masked_accum_spgemm_stream`` in interpret mode, both orders, with
  a nonzero C_prev, at part sizes small enough that rows split.
* The hash merge (``csrc/hash_accum_spgemm.cu``): :func:`hash_emulated`
  follows one warp a row: the load-balanced expand order, the read-first
  probe from the top bits of the Knuth hash, and the extraction by ``extract_class`` of the
  row's occupied slots (the register network over index lane * K + r with
  the value beside each key, after an in-place compaction where the table
  is wider than the class; the shared-memory network past 128 keys). It is
  held to ``hash_accum_plain`` and to the JAX ``hash_accum_spgemm_stream``
  in interpret mode on the conformance cases of
  ``tests/test_torch_hash_accum.py`` (the full-table row included), and at
  4 and 16 times the table.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro.kernels import hash_accum_spgemm as ref_hash
from repro_torch.core.planner import hash_table_slots
from repro_torch.kernels import hash_accum_spgemm as port_hash
from repro_torch.kernels.convert import csr_from_fields
from repro_torch.kernels.sparse_accum_spgemm import SORT_CLASSES, stack_geometry
from test_backend_conformance import CASES
from test_torch_sparse_accum import assert_stacks_match, stage_csr_case
from test_torch_spgemm_redesign import load_balanced_products, stage_dense
from test_torch_triangle import MASKED_CASES, stage_masked_case

ATOL = 1e-5
ORDERS = ("chunk1", "chunk2")
WARP = 32
EMPTY = np.uint32(0xFFFFFFFF)   # the kernel's EMPTY key (-1) read as unsigned
N_SM = 132


def hold_plain(got, want):
    """Structure exact, values within ATOL, of two stacked CSR triples."""
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=ATOL, rtol=0)


def knuth_slot(col: int, table: int) -> int:
    """The reference's start slot, the masked kernel's: the low bits."""
    return (col * port_hash._KNUTH) & (table - 1)


def top_slot(col: int, table: int) -> int:
    """The hash kernel's start slot: the top log2(T) bits of the same hash."""
    return (((col * port_hash._KNUTH) & 0xFFFFFFFF) * table) >> 32


# -- the masked kernel: work list --------------------------------------------


def masked_operands(case: str):
    ref, port, (r0s, r1s), table = stage_masked_case(case)
    return ref, port, r0s, r1s, table


def entry_ranges(Ast):
    """Per global strip row, the range of its A entry slots."""
    ip = Ast.indptr.reshape(-1, Ast.indptr.shape[-1]).long()
    a_cap = Ast.indices.shape[-1]
    return ip[:, :-1].clamp(max=a_cap).flatten(), ip[:, 1:].clamp(max=a_cap).flatten()


@pytest.mark.parametrize("part_size", [None, 64, 7, 1])
@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_work_covers_every_entry_once(case, part_size):
    _, (Ast, Bst, _, Mst), r0s, r1s, _ = masked_operands(case)
    work = port_hash.masked_work(Ast, Bst, Mst, r0s, r1s, N_SM, part_size)
    valid, row, products = port_hash.masked_entry_products(Ast, Bst, r0s, r1s)
    counts = port_hash._mask_row_counts(Mst)
    start, end = entry_ranges(Ast)
    masked_rows = set(torch.nonzero(counts > 0).flatten().tolist())
    # every masked row has parts, no other row has one
    assert set(work.row.tolist()) == masked_rows
    # the parts of a row tile its A entries: contiguous, disjoint, complete
    strip_rows = Ast.indptr.shape[-1] - 1
    flat_products = products.flatten()
    a_cap = Ast.indices.shape[-1]
    for g in masked_rows:
        sel = torch.nonzero(work.row == g).flatten()
        ranges = sorted(zip(work.e0[sel].tolist(), work.e1[sel].tolist()))
        lo, hi = int(start[g]), int(end[g])
        if hi == lo:
            assert ranges == [(lo, lo)]
        else:
            assert ranges[0][0] == lo and ranges[-1][1] == hi
            assert all(b[0] == a[1] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
        assert int(work.first[sel].sum()) == 1
        assert bool((work.only[sel] == (sel.numel() == 1)).all())
        first_part = sel[work.first[sel]]
        assert int(work.e0[first_part]) == min(r[0] for r in ranges)
        base = (g // strip_rows) * a_cap
        for e0, e1, p in zip(work.e0[sel].tolist(), work.e1[sel].tolist(),
                             work.products[sel].tolist()):
            assert p == int(flat_products[base + e0:base + e1].sum())
            assert p <= work.part_size or e1 - e0 == 1
    g = torch.arange(valid.shape[0])[:, None] * strip_rows + row
    masked = valid & (counts[g.clamp(0, counts.numel() - 1)] > 0)
    assert int(work.products.sum()) == int(products[masked].sum())
    # heaviest first
    assert bool((work.products[:-1] >= work.products[1:]).all())
    if part_size is not None and part_size <= 7:
        assert bool((~work.only).any()), "no row was split"


def test_masked_part_size_follows_products_and_sm_count():
    size = port_hash.masked_part_size
    per_sm = port_hash.MASKED_PARTS_PER_SM
    assert size(0, N_SM) == size(1, N_SM) == port_hash.MASKED_PART_MIN
    big = 659_104_106
    assert size(big, N_SM) == -(-big // (N_SM * per_sm))
    assert size(big, 2 * N_SM) == -(-big // (2 * N_SM * per_sm))
    edge = port_hash.MASKED_PART_MIN * N_SM * per_sm
    assert size(edge, N_SM) == port_hash.MASKED_PART_MIN
    assert size(edge + 1, N_SM) == port_hash.MASKED_PART_MIN + 1


def test_masked_launches_group_parts_by_team_and_table():
    """Rows of every table size, three products each: warp teams up to 512
    slots, block teams up to 16,384 (1,024 threads at 16,384), global teams
    above, one launch per (team, table) and one for all global parts; a
    part above MASKED_WARP_PRODUCTS leaves the warp teams."""
    counts = np.array([0, 1, 32, 33, 256, 257, 1024, 1025, 8192, 8193, 40000, 3, 5])
    n_rows, n_cols = counts.size, 50000
    ptr = np.concatenate([[0], np.cumsum(counts)])
    idx = np.concatenate([np.arange(c) for c in counts]).astype(np.int32)
    M = csr_from_fields(ptr, idx, np.ones(idx.size, np.float32), (n_rows, n_cols),
                        int(counts.max()), device="cpu")
    heavy = port_hash.MASKED_WARP_PRODUCTS + 1
    b_len = np.array([3, heavy])
    B = csr_from_fields(np.concatenate([[0], np.cumsum(b_len)]),
                        np.arange(b_len.sum(), dtype=np.int32) % n_cols,
                        np.ones(b_len.sum(), np.float32), (2, n_cols), int(b_len.max()),
                        device="cpu")
    a_col = np.where(np.arange(n_rows) == n_rows - 1, 1, 0).astype(np.int32)
    A = csr_from_fields(np.arange(n_rows + 1), a_col, np.ones(n_rows, np.float32),
                        (n_rows, 2), 1, device="cpu")
    stack = lambda m: dataclasses.replace(  # noqa: E731
        m, indptr=m.indptr[None, None], indices=m.indices[None, None],
        data=m.data[None, None])
    Ast, Bst, Mst = stack(A), stack(B), stack(M)
    work = port_hash.masked_work(Ast, Bst, Mst, [0], [2], N_SM)
    launches = port_hash.masked_launches(work, Mst)
    slots = [port_hash.masked_table_slots(c) for c in counts]
    assert slots[1:5] == [2, 64, 128, 512] and slots[9:11] == [32768, 131072]
    assert launches.groups == [
        (0, 2, 1, 256), (0, 8, 1, 256), (0, 64, 1, 256), (0, 128, 1, 256),
        (0, 512, 1, 256), (1, 16, 1, 512), (1, 1024, 1, 512), (1, 2048, 1, 512),
        (1, 4096, 1, 512), (1, 16384, 1, 1024), (2, 0, 2, 512)]
    rows = launches.parts[:, 0].tolist()
    assert sorted(rows) == list(range(1, n_rows))
    assert rows[5] == n_rows - 1          # the heavy row: a block team, 16 slots
    assert [int(s) for s in launches.slots] == [slots[r] for r in rows]
    assert launches.grows.tolist() == [9, 10]
    assert launches.goff.tolist() == [0, 32768, 32768 + 131072]
    assert launches.pglob.tolist() == [-1] * 10 + [0, 1]
    assert launches.parts[:, 3].tolist() == [3] * (n_rows - 1)   # first and only


# -- the masked kernel: split-and-add ----------------------------------------


class ProbeTable:
    """One linear-probing table as the kernel holds it: seeded, then frozen."""

    def __init__(self, slots: int, cols):
        self.keys = np.full(slots, -1, np.int64)
        self.vals = np.zeros(slots, np.float32)
        for col in cols:
            slot = knuth_slot(int(col), slots)
            for _ in range(slots):
                if self.keys[slot] in (-1, col):
                    self.keys[slot] = col
                    break
                slot = (slot + 1) & (slots - 1)
            else:
                raise AssertionError("a mask key found no slot")

    def find(self, col: int) -> int:
        slots = self.keys.size
        slot = knuth_slot(int(col), slots)
        for _ in range(slots):
            if self.keys[slot] == col:
                return slot
            if self.keys[slot] == -1:
                return -1
            slot = (slot + 1) & (slots - 1)
        return -1

    def add(self, col: int, v) -> None:
        slot = self.find(col)
        if slot >= 0:
            self.vals[slot] = np.float32(self.vals[slot] + np.float32(v))


def masked_emulated(Ast, Bst, C0st, Mst, r0s, r1s, *, order, part_size):
    """The masked kernel's result, launch by launch, part by part."""
    g = stack_geometry(Ast, Bst, C0st, order)
    work = port_hash.masked_work(Ast, Bst, Mst, r0s, r1s, N_SM, part_size)
    launches = port_hash.masked_launches(work, Mst)
    strip_rows, n_ac, c_cap = g["strip_rows"], g["n_ac"], g["c_cap"]
    flat = lambda t: t.reshape(-1, t.shape[-1]).numpy()  # noqa: E731
    a_ix, a_d = flat(Ast.indices), flat(Ast.data)
    b_ip, b_ix, b_d = flat(Bst.indptr), flat(Bst.indices), flat(Bst.data)
    c_ip, c_ix, c_d = flat(C0st.indptr), flat(C0st.indices), flat(C0st.data)
    m_ip, m_ix = flat(Mst.indptr), flat(Mst.indices)
    out_ix = np.zeros_like(c_ix)
    out_d = np.zeros_like(c_d)
    r0s, r1s = np.asarray(r0s), np.asarray(r1s)

    def mask_row(row):
        s, r = divmod(row, strip_rows)
        ms, me = int(m_ip[s, r]), int(m_ip[s, r + 1])
        return s, ms, m_ix[s, ms:me]

    gtables = {int(row): ProbeTable(int(launches.goff[i + 1] - launches.goff[i]),
                                     mask_row(int(row))[2])
                for i, row in enumerate(launches.grows.tolist())}
    steps = [(0, g["n_b"])] if order == "chunk1" else [(j, j + 1) for j in range(g["n_b"])]
    for j_begin, j_end in steps:
        for (row, e0, e1, flags), slots in zip(launches.parts.tolist(),
                                               launches.slots.tolist()):
            s, ms, cols = mask_row(row)
            r, b = row % strip_rows, s // n_ac
            first, only = bool(flags & 1), bool(flags & 2)
            table = gtables.get(row) or ProbeTable(slots, cols)
            if j_begin == 0 and first:
                c0, c1 = min(c_ip[s, r], c_cap), min(c_ip[s, r + 1], c_cap)
                for col, v in zip(c_ix[s, c0:c1], c_d[s, c0:c1]):
                    table.add(col, v)
            for j in range(j_begin, j_end):
                p_cols, p_vals = load_balanced_products(
                    a_ix[s, e0:e1], a_d[s, e0:e1], b_ip[b * g["n_b"] + j],
                    b_ix[b * g["n_b"] + j], b_d[b * g["n_b"] + j], int(r0s[j]), int(r1s[j]),
                    Bst.max_row_nnz, g["chunk_rows"], g["chunk_cap"])
                for col, v in zip(p_cols, p_vals):
                    table.add(col, v)
            if row in gtables:
                continue
            for t, col in enumerate(cols):
                slot = table.find(col)
                assert slot >= 0
                v = table.vals[slot]
                if first and j_begin == 0:
                    out_ix[s, ms + t] = col
                if only:
                    out_d[s, ms + t] = v if j_begin == 0 else np.float32(out_d[s, ms + t] + v)
                elif v != 0:
                    out_d[s, ms + t] = np.float32(out_d[s, ms + t] + v)
    for row, table in gtables.items():
        s, ms, cols = mask_row(row)
        for t, col in enumerate(cols):
            out_ix[s, ms + t] = col
            out_d[s, ms + t] = table.vals[table.find(col)]
    shape = lambda x: torch.from_numpy(x).reshape(C0st.indices.shape)  # noqa: E731
    return (Mst.indptr.clone(), shape(out_ix), shape(out_d)), work


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_emulation_matches_plain_and_reference(case, order):
    ref, port, r0s, r1s, table = masked_operands(case)
    got, work = masked_emulated(*port, r0s, r1s, order=order, part_size=8)
    assert bool((~work.only).any()), "no row was split"
    assert int(port[2].indptr[..., -1].sum()) > 0          # a nonzero C_prev
    hold_plain(got, port_hash.hash_masked_plain(*port, r0s, r1s, order=order,
                                                table_size=table))
    want = ref_hash.hash_masked_accum_spgemm_stream(*ref, r0s, r1s, order=order,
                                                    table_size=table, interpret=True)
    assert_stacks_match(got, want)


@pytest.mark.parametrize("order", ORDERS)
def test_masked_emulation_global_tables(order, monkeypatch):
    """Tables above a lowered shared-memory limit take the global team: the
    row's parts share one table, seeded once, gathered after the last
    launch."""
    monkeypatch.setattr(port_hash, "MASKED_SHARED_MAX", 4)
    _, port, r0s, r1s, table = masked_operands("dense_row")
    got, work = masked_emulated(*port, r0s, r1s, order=order, part_size=8)
    launches = port_hash.masked_launches(work, port[3])
    assert launches.groups[-1][0] == 2 and launches.grows.numel() > 1
    split = set(work.row[~work.only].tolist())
    assert split & set(launches.grows.tolist()), "no global row was split"
    hold_plain(got, port_hash.hash_masked_plain(*port, r0s, r1s, order=order,
                                                table_size=table))


# -- the hash merge -----------------------------------------------------------


def register_network_kv(keys, vals):
    """``bitonic_regs_kv`` over (32, K) keys and values, key r of lane l at
    index l * K + r; returns both flattened in index order."""
    keys, vals = keys.copy(), vals.copy()
    k_per_lane = keys.shape[1]
    lanes = np.arange(WARP)
    k = 2
    while k <= WARP * k_per_lane:
        j = k // 2
        while j > 0:
            for r in range(k_per_lane):
                i = lanes * k_per_lane + r
                if j < k_per_lane:
                    if r & j:
                        continue
                    up = (i & k) == 0
                    x, y = keys[:, r].copy(), keys[:, r | j].copy()
                    xv, yv = vals[:, r].copy(), vals[:, r | j].copy()
                    swap = (x > y) == up
                    keys[:, r], keys[:, r | j] = np.where(swap, y, x), np.where(swap, x, y)
                    vals[:, r], vals[:, r | j] = np.where(swap, yv, xv), np.where(swap, xv, yv)
                else:
                    y = keys[lanes ^ (j // k_per_lane), r]
                    yv = vals[lanes ^ (j // k_per_lane), r]
                    keep_min = ((i & j) == 0) == ((i & k) == 0)
                    take = np.where(keep_min, y < keys[:, r], y > keys[:, r])
                    keys[:, r] = np.where(take, y, keys[:, r])
                    vals[:, r] = np.where(take, yv, vals[:, r])
            j //= 2
        k *= 2
    return keys.reshape(-1), vals.reshape(-1)


def shared_network_kv(keys, vals):
    """``warp_bitonic`` over a flat power-of-two array, swapping values too."""
    keys, vals = keys.copy(), vals.copy()
    t = np.arange(keys.size)
    k = 2
    while k <= keys.size:
        j = k // 2
        while j > 0:
            u = t ^ j
            lo, hi = t[u > t], u[u > t]
            swap = (keys[lo] > keys[hi]) == ((lo & k) == 0)
            a, b = lo[swap], hi[swap]
            keys[a], keys[b] = keys[b].copy(), keys[a].copy()
            vals[a], vals[b] = vals[b].copy(), vals[a].copy()
            j //= 2
        k *= 2
    return keys, vals


def extract_emulated(keys, vals):
    """A row's table out, sorted by column, by the kernel's class of its
    occupied count; returns (columns, values, class)."""
    table = keys.size
    used = keys != EMPTY
    n = int(used.sum())
    cls = port_hash.extract_class(n)
    if cls == "none":
        return [], [], cls
    if cls == "shared":
        n2 = 1 << (n - 1).bit_length()
        k = np.full(n2, EMPTY, np.uint32)
        v = np.zeros(n2, np.float32)
        k[:n], v[:n] = keys[used], vals[used]          # compacted in slot order
        k, v = shared_network_kv(k, v)
        return k[:n].tolist(), v[:n].tolist(), cls
    per_lane = dict(SORT_CLASSES)[cls] // WARP
    src_k, src_v = (keys[used], vals[used]) if table > per_lane * WARP else (keys, vals)
    flat_k = np.full(per_lane * WARP, EMPTY, np.uint32)
    flat_v = np.zeros(per_lane * WARP, np.float32)
    flat_k[:src_k.size], flat_v[:src_v.size] = src_k, src_v
    # slot r * 32 + lane goes to register r of lane
    k, v = register_network_kv(flat_k.reshape(per_lane, WARP).T.copy(),
                               flat_v.reshape(per_lane, WARP).T.copy())
    return k[:n].tolist(), v[:n].tolist(), cls


def insert_read_first(keys, vals, col, v) -> None:
    """The kernel's insert: read the slot (from the top bits of the hash);
    add where it holds the key, claim it where it is empty, else step on."""
    table = keys.size
    slot = top_slot(int(col), table)
    for _ in range(table):
        k = keys[slot]
        if k == EMPTY:
            keys[slot] = col
            k = col
        if k == col:
            vals[slot] = np.float32(vals[slot] + np.float32(v))
            return
        slot = (slot + 1) & (table - 1)
    raise AssertionError(f"hash table of {table} slots is full")


def hash_emulated(Ast, Bst, C0st, r0s, r1s, *, order, table_size):
    """The hash kernel's result, one warp a strip row; returns the stacked
    (indptr, indices, data) and the rows' extraction classes."""
    g = stack_geometry(Ast, Bst, C0st, order)
    c_cap, b_mrn, n_b = g["c_cap"], Bst.max_row_nnz, g["n_b"]
    f = {f"{name}_{fld}": getattr(st, fld).numpy()
         for name, st in (("a", Ast), ("b", Bst), ("c", C0st))
         for fld in ("indptr", "indices", "data")}
    ip = np.zeros_like(f["c_indptr"])
    ix = np.zeros_like(f["c_indices"])
    d = np.zeros_like(f["c_data"])
    classes = {}
    launches = [(0, n_b)] if order == "chunk1" else [(j, j + 1) for j in range(n_b)]
    for b in range(g["batch"]):
        for i in range(g["n_ac"]):
            a_ip, c_ip = f["a_indptr"][b, i], f["c_indptr"][b, i]
            rows_out = []
            for r in range(g["strip_rows"]):
                s, e = min(c_ip[r], c_cap), min(c_ip[r + 1], c_cap)
                acc = (f["c_indices"][b, i, s:e].tolist(), f["c_data"][b, i, s:e].tolist())
                a_s, a_e = min(a_ip[r], g["a_cap"]), min(a_ip[r + 1], g["a_cap"])
                for j_begin, j_end in launches:
                    keys = np.full(table_size, EMPTY, np.uint32)
                    vals = np.zeros(table_size, np.float32)
                    for col, v in zip(*acc):               # C_prev, or the slab
                        insert_read_first(keys, vals, col, v)
                    for j in range(j_begin, j_end):
                        for col, v in zip(*load_balanced_products(
                                f["a_indices"][b, i, a_s:a_e], f["a_data"][b, i, a_s:a_e],
                                f["b_indptr"][b, j], f["b_indices"][b, j],
                                f["b_data"][b, j], int(r0s[j]), int(r1s[j]), b_mrn,
                                g["chunk_rows"], g["chunk_cap"])):
                            insert_read_first(keys, vals, col, v)
                    cols, out_vals, cls = extract_emulated(keys, vals)
                    classes[cls] = classes.get(cls, 0) + 1
                    acc = (cols, out_vals)
                rows_out.append(acc)
            nnz = 0
            for r, (cols, vals) in enumerate(rows_out):
                ip[b, i, r] = nnz
                ix[b, i, nnz:nnz + len(cols)] = cols
                d[b, i, nnz:nnz + len(cols)] = vals
                nnz += len(cols)
            ip[b, i, g["strip_rows"]] = nnz
    return (torch.from_numpy(ip), torch.from_numpy(ix), torch.from_numpy(d)), classes


@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_emulation_matches_plain_and_reference(case):
    ref, port, (r0s, r1s), row_cap = stage_csr_case(case)
    table = hash_table_slots(row_cap)
    for order in ORDERS:
        got, _ = hash_emulated(*port, r0s, r1s, order=order, table_size=table)
        hold_plain(got, port_hash.hash_accum_plain(*port, r0s, r1s, order=order,
                                                   table_size=table))
        want = ref_hash.hash_accum_spgemm_stream(*ref, r0s, r1s, order=order,
                                                 table_size=table, interpret=True)
        assert_stacks_match(got, want)


@pytest.mark.parametrize("scale", [1, 4, 16])
def test_hash_emulation_full_table_row(scale):
    """The dense_row case at its full table (every slot of the dense row's
    table taken), and at 4 and 16 times it, where the occupied slots are
    compacted before the register sort and a row past 128 keys sorts in
    shared memory."""
    _, port, (r0s, r1s), row_cap = stage_csr_case("dense_row")
    table = hash_table_slots(row_cap) * scale
    got, classes = hash_emulated(*port, r0s, r1s, order="chunk1", table_size=table)
    hold_plain(got, port_hash.hash_accum_plain(*port, r0s, r1s, order="chunk1",
                                               table_size=table))
    counts = (got[0][..., 1:] - got[0][..., :-1]).flatten()
    assert int(counts.max()) == row_cap
    assert port_hash.extract_class(row_cap) in classes


def test_hash_emulation_shared_sort():
    """A dense output row of 200 entries: past the largest register class,
    it compacts and sorts in shared memory."""
    rng = np.random.default_rng(19)
    sparse = lambda shape, p: np.where(  # noqa: E731
        rng.random(shape) < p, rng.standard_normal(shape), 0.0).astype(np.float32)
    a, b, c0 = sparse((40, 16), 0.2), sparse((16, 200), 0.05), sparse((40, 200), 0.05)
    a[7], b[3] = rng.standard_normal(16), rng.standard_normal(200)
    ref, port, (r0s, r1s), row_cap = stage_dense(a, b, c0, (0, 13, 26, 40), (0, 5, 10, 16))
    table = hash_table_slots(row_cap)
    assert row_cap == 200
    for order in ORDERS:
        got, classes = hash_emulated(*port, r0s, r1s, order=order, table_size=table)
        assert classes.get("shared", 0) > 0
        hold_plain(got, port_hash.hash_accum_plain(*port, r0s, r1s, order=order,
                                                   table_size=table))
        want = ref_hash.hash_accum_spgemm_stream(*ref, r0s, r1s, order=order,
                                                 table_size=table, interpret=True)
        assert_stacks_match(got, want)


def test_extract_class_boundaries():
    cls = port_hash.extract_class
    assert [cls(n) for n in (0, 1, 32, 33, 64, 65, 128, 129, 4096)] == [
        "none", "reg1", "reg1", "reg2", "reg2", "reg4", "reg4", "shared", "shared"]
    # every class holds its largest count, with the value beside each key
    for name, cap in SORT_CLASSES:
        rng = np.random.default_rng(cap)
        keys = rng.choice(10_000, cap, replace=False).astype(np.uint32)
        vals = keys.astype(np.float32) * np.float32(0.5)
        table = np.full(2 * cap, EMPTY, np.uint32)
        tvals = np.zeros(2 * cap, np.float32)
        for k, v in zip(keys, vals):
            insert_read_first(table, tvals, k, v)
        cols, out, got = extract_emulated(table, tvals)
        assert got == name
        assert cols == sorted(keys.tolist())
        assert out == [c * 0.5 for c in cols]
