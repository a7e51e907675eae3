"""The BSR x dense kernel's group path, by its host side.

No CUDA kernel runs here, so the group kernel's walk and order of sums are
emulated in plain torch and held to the plain version and to the JAX
package's Pallas kernel in interpret mode:

* ``bsr_spmm.choose_path``: ``"group"`` for bs 4, 8, 16, 128-column tiles,
  ``nf`` a multiple of 4 and 16-byte aligned operands, else ``"generic"``;
  the code the wrapper passes to each C entry (a monkeypatched ``launch``)
  and the launches it counts by path.
* The merge walk (lanes following one row each, the warp minimum of the
  heads) against a NumPy oracle (``np.unique`` of each group's block
  columns, and each row's slot at each of them): a small brick3d, random
  BSR with empty block rows and a whole group of sentinel-only rows, ``mb``
  not a multiple of the group size, groups of 2 (shipped), 6, 8 and 12;
  on shuffled rows with interior sentinels it visits every live entry once.
* The group kernel's sums (the walk's steps in order, k inner, one
  bs x 4 tile a lane, no sum across lanes) within 1e-5 of ``bsr_spmm_plain`` and
  within ``test_torch_bsr.py``'s ATOL of the reference's ``bsr_spmm`` in
  interpret mode, at bs 4, 8, 16, ``nf`` 64, 128, 256, f32 and bf16 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.sparse import bsr as ref_bsr
from repro_torch.kernels import bsr_spmm as mod
from repro_torch.kernels import ops
from repro_torch.sparse import bsr, multigrid
from test_torch_bsr import ATOL

EMULATION_ATOL = 1e-5   # the group kernel's order of sums against the plain version's


def _random_bsr(rng, bs, mb, kb, density=0.3, empty=()):
    """A dense matrix of mb x kb blocks of bs (random block pattern, rows in
    ``empty`` without blocks), values scaled so that sums stay near 1."""
    mask = rng.random((mb, kb)) < density
    mask[list(empty)] = False
    vals = rng.standard_normal((mb * bs, kb * bs)) / np.sqrt(bs * max(mask.sum(1).max(), 1))
    return (np.kron(mask, np.ones((bs, bs))) * vals).astype(np.float32)


def _tables(A):
    meta = mod.bsr_spmm_symbolic(A)
    return meta, torch.from_numpy(meta.a_slots), torch.from_numpy(meta.a_cols)


# -- the path ------------------------------------------------------------------

@pytest.mark.parametrize(("bs", "bn", "nf", "offset", "dtype", "want"), [
    (8, 128, 128, 0, torch.float32, "group"), (16, 128, 256, 0, torch.float32, "group"),
    (4, 128, 64, 0, torch.float32, "group"), (8, 128, 132, 0, torch.float32, "group"),
    (8, 128, 128, 0, torch.bfloat16, "group"), (5, 128, 128, 0, torch.float32, "generic"),
    (32, 128, 128, 0, torch.float32, "generic"), (8, 64, 128, 0, torch.float32, "generic"),
    (8, 256, 256, 0, torch.float32, "generic"), (8, 128, 130, 0, torch.float32, "generic"),
    (8, 128, 128, 1, torch.float32, "generic"), (8, 128, 128, 2, torch.bfloat16, "generic"),
])
def test_choose_path(bs, bn, nf, offset, dtype, want):
    x = torch.zeros(bs * 4 * nf + offset, dtype=dtype)[offset:].reshape(bs * 4, nf)
    blocks = torch.zeros(3, bs, bs, dtype=dtype)
    assert mod.choose_path(blocks, x, bs, bn) == want


@pytest.mark.parametrize(("bs", "dtype", "code"), [(8, torch.float32, 0),
                                                 (16, torch.bfloat16, 1),
                                                 (4, torch.float32, 0)])
def test_group_launch_passes_the_tables(monkeypatch, bs, dtype, code):
    """The group path's C entry gets the rows' own column and slot tables,
    u_max, the warps a block, the sentinel and the dtype code; one launch
    counted on it."""
    rng = np.random.default_rng(3)
    A = bsr.bsr_from_dense(_random_bsr(rng, bs, 19, 7), bs, device="cpu")
    meta, sl, co = _tables(A)
    blocks, x = ops._with_zero_block(A.blocks).to(dtype), torch.zeros(7 * bs, 128, dtype=dtype)
    calls = []
    monkeypatch.setattr(mod, "launch", lambda name, fn, ptrs, ints: calls.append(
        (name, fn, ptrs, ints)))
    before = {k: c.count for k, c in mod.PATH_LAUNCHES.items()}
    y = torch.empty(A.mb * bs, 128)
    assert mod._launch(blocks, x, sl, co, y, A.mb, meta.u_max, bs, 128) == "group"
    (name, fn, ptrs, ints), = calls
    assert (name, fn) == ("bsr_spmm", "bsr_spmm_group_launch")
    assert ptrs[0] is blocks and ptrs[1] is x and ptrs[2] is co and ptrs[3] is sl
    assert ptrs[4] is y
    assert ints == [A.mb, meta.u_max, mod.GROUP_WARPS, bs, 128, blocks.shape[0] - 1, code]
    assert {k: c.count - before[k] for k, c in mod.PATH_LAUNCHES.items()} == {
        "group": 1, "generic": 0}


def test_generic_launch_passes_the_tile(monkeypatch):
    rng = np.random.default_rng(4)
    A = bsr.bsr_from_dense(_random_bsr(rng, 5, 9, 6), 5, device="cpu")
    meta, sl, co = _tables(A)
    blocks, x = ops._with_zero_block(A.blocks).bfloat16(), torch.zeros(30, 64).bfloat16()
    calls = []
    monkeypatch.setattr(mod, "launch", lambda name, fn, ptrs, ints: calls.append((fn, ints)))
    before = {k: c.count for k, c in mod.PATH_LAUNCHES.items()}
    assert mod._launch(blocks, x, sl, co, torch.empty(45, 64), 9, meta.u_max, 5, 64) == "generic"
    assert calls == [("bsr_spmm_launch", [9, meta.u_max, 5, 64, 64, blocks.shape[0] - 1, 1])]
    assert {k: c.count - before[k] for k, c in mod.PATH_LAUNCHES.items()} == {
        "group": 0, "generic": 1}


# -- the merge walk ------------------------------------------------------------

def union_oracle(slots, cols, a_zero, warps):
    """Per group: the sorted distinct columns of its rows' live entries and,
    for each of them, {row in the group: its slot there}."""
    out = []
    for g0 in range(0, slots.shape[0], warps):
        s, c = slots[g0:g0 + warps], cols[g0:g0 + warps]
        live = s != a_zero
        out.append([(int(col), {w: int(s[w][live[w] & (c[w] == col)][0])
                                for w in range(s.shape[0]) if (live[w] & (c[w] == col)).any()})
                    for col in np.unique(c[live])])
    return out


def merge_walk(a_slots, a_cols, a_zero, warps):
    """The merge walk as the kernel runs it: lane l < warps follows row
    g * warps + l from its first live entry; a step is the minimum of the
    heads (a warp min), and the rows whose head holds it give their slot and
    move to their next live entry. Returns each group's steps, [(column,
    {row in the group: slot})]."""
    mb, u_max = a_slots.shape
    none = np.iinfo(np.int32).max
    walks = []
    for g0 in range(0, mb, warps):
        pos, head = [0] * warps, [(none, a_zero)] * warps

        def advance(lane):
            row = g0 + lane
            while pos[lane] < u_max:
                if a_slots[row, pos[lane]] != a_zero:
                    head[lane] = (int(a_cols[row, pos[lane]]), int(a_slots[row, pos[lane]]))
                    return
                pos[lane] += 1
            head[lane] = (none, a_zero)
        for lane in range(min(warps, mb - g0)):
            advance(lane)
        steps = []
        while (c := min(h[0] for h in head)) != none:
            mine = {lane: head[lane][1] for lane in range(warps) if head[lane][0] == c}
            steps.append((c, mine))
            for lane in mine:
                pos[lane] += 1
                advance(lane)
        walks.append(steps)
    return walks


def _walk_cases():
    rng = np.random.default_rng(11)
    yield "brick3d6_bs4", bsr.bsr_from_csr(multigrid.brick3d(6, device="cpu"), 4)
    # block rows 2, and 12-35 (a whole group at 2, 3, 6, 8 and 12), without
    # blocks; mb = 43 is a multiple of none of them
    yield "random_empty_rows", bsr.bsr_from_dense(
        _random_bsr(rng, 4, 43, 29, 0.2, [2, *range(12, 36)]), 4, device="cpu")
    yield "random_dense_rows", bsr.bsr_from_dense(_random_bsr(rng, 8, 13, 5, 0.7), 8,
                                                  device="cpu")


@pytest.mark.parametrize("warps", [2, 6, 8, 12])
@pytest.mark.parametrize("case", ["brick3d6_bs4", "random_empty_rows", "random_dense_rows"])
def test_merge_walk_is_the_sorted_union(case, warps):
    """On rows in column order (bsr_spmm_symbolic's) the merge walk's steps
    are each group's sorted union of block columns, each step with the slot
    of every row that names it; a group of sentinel-only rows walks none."""
    A = dict(_walk_cases())[case]
    meta = mod.bsr_spmm_symbolic(A)
    got = merge_walk(meta.a_slots, meta.a_cols, A.nbl_pad, warps)
    want = union_oracle(meta.a_slots, meta.a_cols, A.nbl_pad, warps)
    assert len(got) == -(-A.mb // warps)
    assert got == want
    if case == "random_empty_rows":
        assert [] in got


def walk_sums(walks, a_blocks, x, mb, bs, warps):
    """Y in the group kernel's order of sums: per output element, each step
    of its group's walk in order, k inner (an f32 product added to the
    running sum); every lane's four columns are sums of their own."""
    a32, x32 = a_blocks.float(), x.float()
    y = torch.zeros(-(-mb // warps) * warps * bs, x.shape[1])
    for g, steps in enumerate(walks):
        for col, mine in steps:
            for w, slot in mine.items():
                rows = slice((g * warps + w) * bs, (g * warps + w + 1) * bs)
                for k in range(bs):
                    y[rows] += a32[slot][:, k, None] * x32[col * bs + k]
    return y[:mb * bs]


@pytest.mark.parametrize("warps", [2, 8])
def test_walks_on_shuffled_rows(warps):
    """Rows shuffled (sentinels inside, columns out of order): the walk
    visits every live entry once, and its sums hold the plain version."""
    rng = np.random.default_rng(17)
    bs = 4
    A = bsr.bsr_from_dense(_random_bsr(rng, bs, 31, 13, 0.3, [5, 6]), bs, device="cpu")
    meta = mod.bsr_spmm_symbolic(A)
    perm = np.argsort(rng.random(meta.a_slots.shape), axis=1)
    sl_np = np.take_along_axis(meta.a_slots, perm, 1)
    co_np = np.take_along_axis(meta.a_cols, perm, 1)
    sl, co = torch.from_numpy(sl_np), torch.from_numpy(co_np)
    assert ((sl_np[:, :-1] == A.nbl_pad) & (sl_np[:, 1:] != A.nbl_pad)).any()
    blocks = ops._with_zero_block(A.blocks)
    x = torch.from_numpy(rng.standard_normal((A.shape[1], 64)).astype(np.float32))
    want = mod.bsr_spmm_plain(blocks, x, sl, co, A.mb, meta.u_max, bs)
    rows, cols = np.nonzero(sl_np != A.nbl_pad)
    live = sorted(zip(rows.tolist(), sl_np[rows, cols].tolist()))
    walks = merge_walk(sl_np, co_np, A.nbl_pad, warps)
    seen = sorted((g * warps + w, slot) for g, steps in enumerate(walks)
                  for _, mine in steps for w, slot in mine.items())
    assert seen == live   # (row, slot) of every live entry, once
    got = walk_sums(walks, blocks, x, A.mb, bs, warps)
    torch.testing.assert_close(got, want, atol=EMULATION_ATOL, rtol=0)


# -- the group kernel's sums against the plain version and the reference -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nf", [64, 128, 256])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_group_sums_match_plain_and_reference(bs, nf, dtype):
    rng = np.random.default_rng(100 * bs + nf)
    mb, kb = 11, 6   # groups of GROUP_WARPS rows, the last one short
    da = _random_bsr(rng, bs, mb, kb, 0.35, [4])
    x = rng.standard_normal((kb * bs, nf)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    A = bsr.bsr_from_dense(torch.tensor(da).to(tdt), bs, device="cpu")
    xt = torch.tensor(x).to(tdt)
    meta, sl, co = _tables(A)
    blocks = ops._with_zero_block(A.blocks)
    assert mb % mod.GROUP_WARPS
    walks = merge_walk(meta.a_slots, meta.a_cols, A.nbl_pad, mod.GROUP_WARPS)
    got = walk_sums(walks, blocks, xt, mb, bs, mod.GROUP_WARPS)
    want = mod.bsr_spmm_plain(blocks, xt, sl, co, mb, meta.u_max, bs)
    torch.testing.assert_close(got, want, atol=EMULATION_ATOL, rtol=0)
    rA = ref_bsr.bsr_from_dense(jnp.asarray(da, jdt), bs)
    ref_y = ref_ops.bsr_spmm(rA, jnp.asarray(x, jdt), bn=min(128, nf), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_y, np.float32), atol=ATOL, rtol=0)
