"""The ESC merge and the BSR x BSR kernel as their CUDA kernels compute them,
emulated step by step in NumPy on the CPU (no kernel runs here).

* ESC (``csrc/sparse_accum_spgemm.cu``): :func:`esc_emulated` follows the
  kernel's merge of one strip row and chunk: the load-balanced expand (the
  product counts of 32 A entries scanned, lane l taking products l, l + 32,
  ... of the batch and finding its A entry by a binary search of the scan),
  keys packed as ``(column << pos_bits) | position`` in 32 or 64 bits
  (``key_bits``), the sort by size class (``sort_class``: the register
  network over index lane * K + r, compare-swaps inside a lane below stride
  K and exchanges with lane ^ (stride / K) above; the shared-memory bitonic
  sort past 128 keys or for 64-bit keys) and the compress, which sums each
  run in sorted order from 0.0f (from the registers: runs carried across
  lanes). It must give ``sparse_accum_plain``'s structure and values bit
  for bit, and the JAX ``sparse_accum_spgemm_stream`` (interpret mode)
  within atol 1e-4: on the conformance cases of
  ``tests/test_torch_sparse_accum.py``, a row whose products sum to zero,
  a row past the largest register class, and columns too wide for 32-bit
  keys. The host rules hold at their boundaries, and ``sort_steps`` counts
  the steps the emulation takes.
* BSR (``csrc/bsr_spgemm.cu``): :func:`bsr_emulated` follows one warp per C
  block: slot passes of 32, the ballot of live steps (a sentinel skipped
  wherever it stands), the live steps in order, each an f32 FMA over k, and
  the lanes' output tiles. It is held to ``bsr_spgemm_plain`` and to the JAX
  ``bsr_spgemm_blocks`` (interpret mode) within atol 1e-4, with interior
  sentinels, all-sentinel rows and 40 steps a row, at blocks of 4, 8 and
  16, in f32 and bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro.kernels.bsr_spgemm import bsr_spgemm_blocks as ref_bsr_blocks
from repro.kernels.sparse_accum_spgemm import sparse_accum_spgemm_stream as ref_stream
from repro.sparse.csr import csr_from_dense, csr_pad_to, csr_stack
from repro_torch.kernels import bsr_spgemm as port_bsr
from repro_torch.kernels import sparse_accum_spgemm as esc
from test_backend_conformance import CASES
from test_torch_sparse_accum import _port, stage_csr_case

ATOL = 1e-4
ORDERS = ("chunk1", "chunk2")
WARP = 32
BSR_TILE_SIZES = (8, 16, 32)   # block sizes csrc/bsr_spgemm.cu keeps as register tiles


# -- ESC -------------------------------------------------------------------


def load_balanced_products(a_cols, a_vals, b_ip, b_ix, b_d, r0, r1, b_mrn, chunk_rows,
                           chunk_cap):
    """A row's in-range products as the kernel's lanes find them: per batch of
    32 A entries the exclusive scan of their product counts, then product q
    of the batch (lane q % 32, round q // 32) from its A entry, the last lane
    whose scan is <= q (the kernel's binary search). Returns (columns,
    values) in position order."""
    cols, vals = [], []
    for base in range(0, len(a_cols), WARP):
        cnt = np.zeros(WARP, np.int64)
        start = np.zeros(WARP, np.int64)
        a_val = np.zeros(WARP, np.float32)
        for lane, (col, val) in enumerate(zip(a_cols[base:base + WARP],
                                              a_vals[base:base + WARP])):
            if r0 <= col < r1:
                b_row = min(max(col - r0, 0), chunk_rows - 1)
                start[lane] = b_ip[b_row]
                cnt[lane] = max(min(b_ip[b_row + 1] - start[lane], b_mrn), 0)
                a_val[lane] = val
        excl = np.cumsum(cnt) - cnt
        for q in range(int(cnt.sum())):
            lo = 0
            for step in (16, 8, 4, 2, 1):
                if excl[lo + step] <= q:
                    lo += step
            assert excl[lo] <= q < excl[lo] + cnt[lo]
            src = min(start[lo] + q - excl[lo], chunk_cap - 1)
            cols.append(int(b_ix[src]))
            vals.append(np.float32(a_val[lo] * np.float32(b_d[src])))
    return cols, vals


def register_network(keys):
    """The kernel's bitonic network over a (32, K) array of keys, key r of
    lane l at index l * K + r, stage by stage."""
    keys = keys.copy()
    k_per_lane = keys.shape[1]
    lanes = np.arange(WARP)
    k = 2
    while k <= WARP * k_per_lane:
        j = k // 2
        while j > 0:
            for r in range(k_per_lane):
                i = lanes * k_per_lane + r
                if j < k_per_lane:        # compare-swap inside the lane
                    if r & j:
                        continue
                    up = (i & k) == 0
                    x, y = keys[:, r].copy(), keys[:, r | j].copy()
                    swap = (x > y) == up
                    keys[:, r] = np.where(swap, y, x)
                    keys[:, r | j] = np.where(swap, x, y)
                else:                     # exchange with lane ^ (j / K)
                    y = keys[lanes ^ (j // k_per_lane), r]
                    keep_min = ((i & j) == 0) == ((i & k) == 0)
                    keys[:, r] = np.where(keep_min, np.minimum(keys[:, r], y),
                                          np.maximum(keys[:, r], y))
            j //= 2
        k *= 2
    return keys.reshape(-1)


def shared_network(keys):
    """``warp_bitonic`` over a flat power-of-two array, stage by stage."""
    keys = keys.copy()
    t = np.arange(keys.size)
    k = 2
    while k <= keys.size:
        j = k // 2
        while j > 0:
            u = t ^ j
            first = u > t
            lo, hi = t[first], u[first]
            x, y = keys[lo].copy(), keys[hi].copy()
            swap = (x > y) == ((lo & k) == 0)
            keys[lo] = np.where(swap, y, x)
            keys[hi] = np.where(swap, x, y)
            j //= 2
        k *= 2
    return keys


def sort_keys(cols, work_cap):
    """The step's sorted keys and their shift, by the kernel's size class
    and key width, with the class label of ``sort_steps``: a flat array for
    the shared-memory class, the (32, K) registers for a register class."""
    n = len(cols)
    cls = esc.sort_class(n, esc.key_bits(max(cols) + 1, work_cap))
    pos = np.arange(n, dtype=np.uint64)
    if cls in ("shared", "wide"):   # 64-bit keys in shared memory
        n2 = 1 << (n - 1).bit_length()
        keys = np.full(n2, np.iinfo(np.uint64).max, np.uint64)
        keys[:n] = (np.asarray(cols, np.uint64) << np.uint64(32)) | pos
        return shared_network(keys)[:n], 32, f"{cls}/64"
    per_lane = dict(esc.SORT_CLASSES)[cls] // WARP
    shift = (work_cap - 1).bit_length()
    flat = np.full(WARP * per_lane, np.iinfo(np.uint32).max, np.uint32)
    flat[:n] = ((np.asarray(cols, np.uint64) << np.uint64(shift)) | pos).astype(np.uint32)
    # position r * 32 + l sits in register r of lane l
    keys = flat.reshape(per_lane, WARP).T
    return register_network(keys).reshape(WARP, per_lane), shift, f"{cls}/32"


def compress(sorted_keys, shift, vals):
    """One run of equal columns a segment, summed in sorted order from 0.0f."""
    cols_out, vals_out = [], []
    mask = (1 << shift) - 1
    for key in sorted_keys:
        col, pos = int(key) >> shift, int(key) & mask
        if not cols_out or cols_out[-1] != col:
            cols_out.append(col)
            vals_out.append(np.float32(0.0))
        vals_out[-1] = np.float32(vals_out[-1] + vals[pos])
    return cols_out, vals_out


def compress_registers(keys, n, shift, vals):
    """The kernel's compress from the sorted registers (``compress_regs``):
    heads numbered by a warp scan, each lane's runs summed in order from
    0.0f, a run that starts in an earlier lane carried in from the lane
    before (lanes pass trailing sums up until every waiting lane has one),
    each run written by the lane where it ends."""
    k_per_lane = keys.shape[1]
    lanes = np.arange(WARP)
    valid = (lanes[:, None] * k_per_lane + np.arange(k_per_lane)) < n
    col = (keys >> keys.dtype.type(shift)).astype(np.int64)
    pos = (keys & keys.dtype.type((1 << shift) - 1)).astype(np.int64)
    v = np.where(valid, vals[np.where(valid, pos, 0)], np.float32(0)).astype(np.float32)
    prev = np.concatenate([col[:1, -1], col[:-1, -1]])          # __shfl_up_sync
    head = valid.copy()
    head[:, 1:] &= col[:, 1:] != col[:, :-1]
    head[:, 0] &= (lanes == 0) | (prev != col[:, 0])
    heads = head.sum(1)
    incl = np.cumsum(heads)
    starts = head[:, 0] | ~valid[:, 0]
    next_starts = np.concatenate([starts[1:], [True]])           # __shfl_down_sync
    trail = np.zeros(WARP, np.float32)
    for r in range(k_per_lane):
        trail = np.where(valid[:, r], np.where(head[:, r], np.float32(0), trail) + v[:, r],
                         trail).astype(np.float32)
    trail_seg = incl - 1
    ready = (heads > 0) | ~valid[:, 0]
    need = valid[:, 0] & ~head[:, 0]
    lead = np.zeros(WARP, np.float32)
    lead_seg = np.zeros(WARP, np.int64)
    while need.any():
        c, cs, cr = (np.concatenate([x[:1], x[:-1]]) for x in (trail, trail_seg, ready))
        take = need & cr
        for lane in np.flatnonzero(take):
            s = c[lane]
            for r in range(k_per_lane):
                if not valid[lane, r] or head[lane, r]:
                    break
                s = np.float32(s + v[lane, r])
            lead[lane], lead_seg[lane] = s, cs[lane]
            if heads[lane] == 0:
                trail[lane], trail_seg[lane], ready[lane] = s, cs[lane], True
        need &= ~take
    out = {}
    for lane in range(WARP):
        total, seg, seen = lead[lane], lead_seg[lane], incl[lane] - heads[lane]
        for r in range(k_per_lane):
            if head[lane, r]:
                total, seg, seen = np.float32(0), seen, seen + 1
            if seen > incl[lane] - heads[lane]:
                total = np.float32(total + v[lane, r])
            last = r + 1 == k_per_lane
            ends = valid[lane, r] and (next_starts[lane] if last else
                                       not valid[lane, r + 1] or head[lane, r + 1])
            if ends:
                assert seg not in out
                out[int(seg)] = (int(col[lane, r]), total)
    assert sorted(out) == list(range(int(incl[-1])))
    return [out[i][0] for i in range(len(out))], [out[i][1] for i in range(len(out))]


def esc_emulated(Ast, Bst, C0st, r0s, r1s, *, row_cap):
    """The ESC kernel's result on stacked port operands, merge step by merge
    step; returns the stacked (indptr, indices, data) and the steps taken
    by ``"class/key bits"``."""
    g = esc.stack_geometry(Ast, Bst, C0st, "chunk1")
    work_cap, _ = esc.esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, max(row_cap, 1))
    c_cap, b_mrn = g["c_cap"], Bst.max_row_nnz
    f = {f"{name}_{fld}": getattr(st, fld).numpy()
         for name, st in (("a", Ast), ("b", Bst), ("c", C0st))
         for fld in ("indptr", "indices", "data")}
    ip = np.zeros_like(C0st.indptr.numpy())
    ix = np.zeros_like(C0st.indices.numpy())
    d = np.zeros_like(C0st.data.numpy())
    steps = {}
    for b in range(g["batch"]):
        for i in range(g["n_ac"]):
            a_ip, c_ip = f["a_indptr"][b, i], f["c_indptr"][b, i]
            rows_out = []
            for r in range(g["strip_rows"]):
                s, e = min(c_ip[r], c_cap), min(c_ip[r + 1], c_cap)
                acc_cols = [int(v) for v in f["c_indices"][b, i, s:e]]
                acc_vals = list(f["c_data"][b, i, s:e])
                a_s, a_e = min(a_ip[r], g["a_cap"]), min(a_ip[r + 1], g["a_cap"])
                for j in range(g["n_b"]):
                    cols, vals = load_balanced_products(
                        f["a_indices"][b, i, a_s:a_e], f["a_data"][b, i, a_s:a_e],
                        f["b_indptr"][b, j], f["b_indices"][b, j], f["b_data"][b, j],
                        int(r0s[j]), int(r1s[j]), b_mrn, g["chunk_rows"], g["chunk_cap"])
                    cols, vals = cols + acc_cols, vals + acc_vals
                    if not cols:
                        steps["none"] = steps.get("none", 0) + 1
                        continue
                    assert len(cols) <= work_cap
                    keys, shift, label = sort_keys(cols, work_cap)
                    steps[label] = steps.get(label, 0) + 1
                    vals = np.asarray(vals, np.float32)
                    acc_cols, acc_vals = (compress(keys, shift, vals) if keys.ndim == 1
                                          else compress_registers(keys, len(cols), shift, vals))
                    assert len(acc_cols) <= row_cap
                rows_out.append((acc_cols, acc_vals))
            nnz = 0
            for r, (cols, vals) in enumerate(rows_out):
                ip[b, i, r] = nnz
                ix[b, i, nnz:nnz + len(cols)] = cols
                d[b, i, nnz:nnz + len(cols)] = vals
                nnz += len(cols)
            ip[b, i, g["strip_rows"]] = nnz
    return (torch.from_numpy(ip), torch.from_numpy(ix), torch.from_numpy(d)), steps


def assert_plain_equal(got, Ast, Bst, C0st, r0s, r1s):
    """Structure and values bit for bit against the plain version, both orders."""
    for order in ORDERS:
        want = esc.sparse_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order)
        for x, y in zip(got, want):
            assert torch.equal(x, y), order


def assert_reference_close(got, ref_ops, r0s, r1s):
    for order in ORDERS:
        want = ref_stream(*ref_ops, r0s, r1s, order=order, interpret=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL, rtol=0)


def stage_dense(a, b, c0, p_ac, p_b):
    """Reference and port stacks of dense A, B and C_prev under a plan's
    strip and chunk cuts, C_prev's strips at the exact output capacity."""
    strips = [csr_from_dense(a[s:e]) for s, e in zip(p_ac[:-1], p_ac[1:])]
    rows = max(e - s for s, e in zip(p_ac[:-1], p_ac[1:]))
    strips = [csr_pad_to(m, max(m.nnz_pad for m in strips), rows,
                         max(m.max_row_nnz for m in strips)) for m in strips]
    chunks = [csr_from_dense(b[s:e]) for s, e in zip(p_b[:-1], p_b[1:])]
    k_rows = max(e - s for s, e in zip(p_b[:-1], p_b[1:]))
    chunks = [csr_pad_to(m, max(m.nnz_pad for m in chunks), k_rows,
                         max(m.max_row_nnz for m in chunks)) for m in chunks]
    product = ((a != 0).astype(np.int64) @ (b != 0).astype(np.int64) > 0) | (c0 != 0)
    c_cap = max(8, -(-max(int(product[s:e].sum()) for s, e in zip(p_ac[:-1], p_ac[1:]))
                     // 8) * 8)
    c0s = []
    for s, e in zip(p_ac[:-1], p_ac[1:]):
        block = np.zeros((rows, b.shape[1]), np.float32)
        block[: e - s] = c0[s:e]
        c0s.append(csr_pad_to(csr_from_dense(block, pad_to=c_cap), max_row_nnz=c_cap))
    ref = (csr_stack([csr_stack(strips)]), csr_stack([csr_stack(chunks)]),
           csr_stack([csr_stack(c0s)]))
    r0s = np.asarray(p_b[:-1], np.int32)
    r1s = np.asarray(p_b[1:], np.int32)
    return ref, tuple(_port(m) for m in ref), (r0s, r1s), int(product.sum(1).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_esc_emulation_matches_plain_and_reference(case):
    ref, port, (r0s, r1s), row_cap = stage_csr_case(case)
    got, steps = esc_emulated(*port, r0s, r1s, row_cap=row_cap)
    assert_plain_equal(got, *port, r0s, r1s)
    assert_reference_close(got, ref, r0s, r1s)
    assert steps == esc.sort_steps(*port, r0s, r1s, row_cap=row_cap)


def test_esc_emulation_keeps_a_zero_sum_entry():
    """Two products that cancel exactly leave an entry holding 0.0, in the
    kernel's compress as in the plain version and the reference."""
    a = np.zeros((6, 5), np.float32)
    b = np.zeros((5, 7), np.float32)
    a[1, 0], a[1, 1], a[1, 3] = 1.0, -1.0, 0.5
    b[0, 2], b[1, 2], b[0, 4], b[3, 6] = 2.5, 2.5, 1.0, 3.0
    ref, port, (r0s, r1s), row_cap = stage_dense(a, b, np.zeros((6, 7), np.float32),
                                                 (0, 3, 6), (0, 5))
    got, _ = esc_emulated(*port, r0s, r1s, row_cap=row_cap)
    nnz = int(got[0][0, 0, -1])
    cols = got[1][0, 0, :nnz].tolist()
    assert cols == [2, 4, 6]
    assert got[2][0, 0, 0] == 0.0
    assert_plain_equal(got, *port, r0s, r1s)
    assert_reference_close(got, ref, r0s, r1s)


@pytest.mark.parametrize("p_b", [(0, 24), (0, 8, 16, 24)])
def test_esc_emulation_past_the_register_classes(p_b):
    """A dense row whose step holds more than 128 keys sorts in shared
    memory, under one chunk and under three (where its accumulator joins
    the later steps)."""
    rng = np.random.default_rng(31)
    a = np.where(rng.random((20, 24)) < 0.2, rng.standard_normal((20, 24)), 0)
    b = np.where(rng.random((24, 300)) < 0.05, rng.standard_normal((24, 300)), 0)
    c0 = np.where(rng.random((20, 300)) < 0.03, rng.standard_normal((20, 300)), 0)
    a[7] = rng.standard_normal(24)
    b[2] = rng.standard_normal(300)
    a, b, c0 = (m.astype(np.float32) for m in (a, b, c0))
    ref, port, (r0s, r1s), row_cap = stage_dense(a, b, c0, (0, 10, 20), p_b)
    got, steps = esc_emulated(*port, r0s, r1s, row_cap=row_cap)
    assert "shared/64" in steps
    assert_plain_equal(got, *port, r0s, r1s)
    assert_reference_close(got, ref, r0s, r1s)


def test_esc_emulation_wide_columns_take_64_bit_keys():
    """Columns past 2^(32 - pos_bits) do not fit a 32-bit key beside the
    position; such steps sort 64-bit keys in shared memory ("wide"), the
    others 32-bit keys in registers."""
    from repro_torch.sparse.csr import CSR, csr_from_coo, csr_stack as port_stack

    rng = np.random.default_rng(32)
    rows, k, n = 12, 6, (1 << 30) + 9
    a = np.where(rng.random((rows, k)) < 0.5, rng.standard_normal((rows, k)), 0)
    a = a.astype(np.float32)
    b_rows = np.repeat(np.arange(k), 5)
    b_cols = np.concatenate([rng.choice(n, 5, replace=False) for _ in range(k)])
    b_cols[:5] = np.arange(5)          # B row 0 stays in the narrow columns
    b_vals = rng.standard_normal(b_rows.size).astype(np.float32)
    a[0], a[1] = 0, 0
    a[0, 0] = a[1, 0] = 1.5            # rows 0 and 1 reach only B row 0
    A = csr_from_coo(*np.nonzero(a), a[np.nonzero(a)], (rows, k), device="cpu")
    B = csr_from_coo(b_rows, b_cols, b_vals, (k, n), device="cpu")
    row_cap = max(len({int(c) for j in np.flatnonzero(a[i]) for c in b_cols[b_rows == j]})
                  for i in range(rows))
    c_cap = -(-rows * row_cap // 8) * 8
    C0 = CSR(torch.zeros(1, 1, rows + 1, dtype=torch.int32),
                 torch.zeros(1, 1, c_cap, dtype=torch.int32),
                 torch.zeros(1, 1, c_cap), (rows, n), c_cap)
    Ast, Bst = port_stack([port_stack([A])]), port_stack([port_stack([B])])
    r0s, r1s = np.array([0], np.int32), np.array([k], np.int32)
    got, steps = esc_emulated(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
    assert steps.get("wide/64", 0) > 0 and steps.get("reg1/32", 0) >= 2
    assert_plain_equal(got, Ast, Bst, C0, r0s, r1s)
    assert steps == esc.sort_steps(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)


@pytest.mark.parametrize("n, want", [
    (0, "none"), (1, "reg1"), (32, "reg1"), (33, "reg2"), (64, "reg2"), (65, "reg4"),
    (128, "reg4"), (129, "shared"), (4096, "shared")])
def test_sort_class_boundaries(n, want):
    assert esc.sort_class(n) == want
    # 64-bit keys leave the register classes, not the empty or the large steps
    assert esc.sort_class(n, 64) == (want if want in ("none", "shared") else "wide")


@pytest.mark.parametrize("n_cols, work_cap, want", [
    (1, 1, 32), (1 << 24, 256, 32), ((1 << 24) + 1, 256, 64), (1 << 21, 2048, 32),
    ((1 << 21) + 1, 2048, 64), (1 << 21, 2049, 64), (1 << 32, 1, 32), ((1 << 32) + 1, 1, 64),
    (13_824, 256, 32)])
def test_key_bits_boundaries(n_cols, work_cap, want):
    assert esc.key_bits(n_cols, work_cap) == want


def test_kernels_per_call():
    assert esc.kernels_per_call("chunk1", 4) == 3
    assert esc.kernels_per_call("chunk2", 1) == 3
    assert esc.kernels_per_call("chunk2", 4) == 6


@pytest.mark.parametrize("k_per_lane", [1, 2, 4])
def test_register_compress_matches_sequential_sums(k_per_lane):
    """Runs that span many lanes (one column over 3/4 of the keys), runs of
    one key, negative zeros, and a partly filled last lane: the lane-level
    compress gives the sequential compress's columns and bits."""
    rng = np.random.default_rng(60 + k_per_lane)
    n = WARP * k_per_lane - 3
    cols = np.sort(np.concatenate([np.full(3 * n // 4, 7), rng.integers(0, 40, n - 3 * n // 4)]))
    vals = rng.standard_normal(n).astype(np.float32)
    vals[::5] = np.float32(-0.0)
    vals[1::7] = -vals[0::7][: vals[1::7].size]        # some cancellation
    shift = 16
    keys = np.full(WARP * k_per_lane, np.iinfo(np.uint32).max, np.uint32)
    keys[:n] = (cols.astype(np.uint32) << np.uint32(shift)) | np.arange(n, dtype=np.uint32)
    got = compress_registers(keys.reshape(WARP, k_per_lane), n, shift, vals)
    want = compress(keys[:n], shift, vals)
    assert got[0] == want[0]
    assert np.asarray(got[1], np.float32).tobytes() == np.asarray(want[1], np.float32).tobytes()


@pytest.mark.parametrize("k_per_lane", [1, 2, 4])
def test_register_network_sorts(k_per_lane):
    rng = np.random.default_rng(k_per_lane)
    keys = rng.permutation(WARP * k_per_lane * 3)[: WARP * k_per_lane].astype(np.uint32)
    got = register_network(keys.reshape(k_per_lane, WARP).T)
    np.testing.assert_array_equal(got, np.sort(keys))


# -- BSR -------------------------------------------------------------------


def lane_tile(bs: int, lane: int):
    """The output elements (i, j) a lane keeps: a bs/8 x bs/4 sub-tile for
    the kernel's tile sizes, elements lane + 32 t otherwise."""
    if bs in BSR_TILE_SIZES:
        rows, cols = bs // 8, bs // 4
        i0, j0 = (lane // 4) * rows, (lane % 4) * cols
        return [(i0 + r, j0 + c) for r in range(rows) for c in range(cols)]
    return [divmod(o, bs) for o in range(lane, bs * bs, WARP)]


@pytest.mark.parametrize("bs", [1, 3, 4, 8, 16, 32])
def test_bsr_lane_tiles_cover_the_block_once(bs):
    cells = [c for lane in range(WARP) for c in lane_tile(bs, lane)]
    assert sorted(cells) == [(i, j) for i in range(bs) for j in range(bs)]


def bsr_emulated(a_blocks, b_blocks, a_slots, b_slots, nc_pad, u_max, bs, skip_zero=True):
    """One warp per C block: passes of 32 slots, the ballot of live steps,
    each live step (in order) an f32 FMA over k into the lanes' tiles."""
    a = a_blocks.float().numpy().astype(np.float64)
    b = b_blocks.float().numpy().astype(np.float64)
    sa_all, sb_all = np.asarray(a_slots), np.asarray(b_slots)
    a_zero = a.shape[0] - 1
    out = np.zeros((nc_pad, bs, bs), np.float32)
    lanes = np.arange(WARP)
    for e in range(nc_pad):
        acc = np.zeros((bs, bs), np.float32)
        for u0 in range(0, u_max, WARP):
            in_row = u0 + lanes < u_max
            idx = np.minimum(u0 + lanes, u_max - 1)
            sa = np.where(in_row, sa_all[e, idx], a_zero)
            sb = np.where(in_row, sb_all[e, idx], 0)
            live = in_row & ((not skip_zero) | (sa != a_zero))
            for src in np.flatnonzero(live):          # __ffs order
                blk_a, blk_b = a[sa[src]], b[sb[src]]
                for k in range(bs):                   # fmaf, k in order
                    acc = (blk_a[:, k:k + 1] * blk_b[k:k + 1, :] + acc).astype(np.float32)
        for lane in range(WARP):
            for i, j in lane_tile(bs, lane):
                out[e, i, j] = acc[i, j]
    return torch.from_numpy(out)


def bsr_case(bs, dtype, seed, nc=24, u_max=40):
    """Seeded blocks (sentinel appended) and slot tables: 70% of the steps
    dead wherever they stand, rows 5-8 all sentinel."""
    gen = torch.Generator().manual_seed(seed)
    nbl_a, nbl_b = 30, 36
    a = torch.randn(nbl_a + 1, bs, bs, generator=gen)
    b = torch.randn(nbl_b + 1, bs, bs, generator=gen)
    a[-1], b[-1] = 0, 0
    sa = torch.randint(0, nbl_a, (nc, u_max), generator=gen, dtype=torch.int32)
    sb = torch.randint(0, nbl_b, (nc, u_max), generator=gen, dtype=torch.int32)
    dead = torch.rand(nc, u_max, generator=gen) < 0.7
    dead[5:9] = True
    sa[dead], sb[dead] = nbl_a, nbl_b
    interior = ((sa[:, :-1] == nbl_a) & (sa[:, 1:] != nbl_a)).any(1).sum()
    assert interior > 0 and (sa[:, 32:] != nbl_a).any()
    return a.to(dtype), b.to(dtype), sa, sb, nc, u_max


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_bsr_emulation_matches_plain_and_reference(bs, dtype):
    a, b, sa, sb, nc, u_max = bsr_case(bs, dtype, 40 + bs)
    got = bsr_emulated(a, b, sa, sb, nc, u_max, bs)
    assert not got[5:9].any()
    want = port_bsr.bsr_spgemm_plain(a, b, sa, sb, nc, u_max, bs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = ref_bsr_blocks(jnp.asarray(a.float().numpy(), jdt), jnp.asarray(b.float().numpy(), jdt),
                         jnp.asarray(sa.numpy()), jnp.asarray(sb.numpy()), nc, u_max, bs,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


def test_bsr_emulation_every_step_live_without_skip():
    a, b, sa, sb, nc, u_max = bsr_case(8, torch.float32, 77, nc=10)
    got = bsr_emulated(a, b, sa, sb, nc, u_max, 8, skip_zero=False)
    want = port_bsr.bsr_spgemm_plain(a, b, sa, sb, nc, u_max, 8, skip_zero=False)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)

