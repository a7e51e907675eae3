"""The f32 FMA routes of the grouped GEMM and the prefill kernel, by their host side.

No CUDA kernel runs here, so the kernels' orders of sums are emulated step
by step in plain torch and held to the plain versions and to the JAX
package's Pallas kernels in interpret mode:

* ``grouped_matmul.fma_tiling``: ``"rows_few"`` at or below
  ``SMALL_ROWS_MAX`` rows, ``"tile"`` above; the wrapper passes the
  tiling's code to the C entry and counts the launch by tiling.
* The grouped GEMM's rows-few tiling (a block per segment and 64- or
  128-column slab, passes of 8 rows, each warp's k interleaved four at a
  time over 32-deep stages, the lanes of a column and then the 8 warps
  added in order) and its tile tiling (every output summed over k in
  order), on empty segments, one-row segments, segments longer than a pass
  and K and N off 8: within ``chip_smoke.py``'s f32 gate (atol 1e-4 +
  rtol 1e-5) of ``grouped_matmul_plain`` and of the reference's
  ``grouped_matmul_padded``.
* The prefill kernel's fma route (64 query rows of a block folded over the
  GQA group, 64-key tiles from the window's first to the diagonal, S in
  4-deep steps of d, a row's max over its 16 threads, per-thread partial
  sums rescaled by each tile's max and added by a shuffle tree at the end,
  P V over the tile's keys in order): within ``chip_smoke.py``'s
  ``ATTN_F32_ATOL`` of ``flash_prefill_plain`` and of the reference's
  ``flash_prefill``, for g 1, 3, 4, 8, 9, D 64 and 128, window 0 and 24,
  S off the tile edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_F32_ATOL, GMM_F32_ATOL, GMM_F32_RTOL
from repro.kernels import grouped_matmul as ref_gmm
from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import grouped_matmul as gmm

NEG_INF = -1e30


# -- the grouped GEMM ---------------------------------------------------------

@pytest.mark.parametrize("t,want", [(0, "rows_few"), (1, "rows_few"), (64, "rows_few"),
                                    (511, "rows_few"), (512, "rows_few"), (513, "tile"),
                                    (1024, "tile"), (123_968, "tile")])
def test_fma_tiling_by_rows(t, want):
    assert gmm.SMALL_ROWS_MAX == 512
    assert gmm.fma_tiling(t) == want


@pytest.mark.parametrize("t", [64, 512, 513, 700])
def test_fma_launch_passes_the_tiling(monkeypatch, t):
    """The wrapper's launch on the fma route: the C entry's route argument
    is the tiling's code, and the launch is counted by tiling."""
    calls = []
    monkeypatch.setattr(gmm, "launch", lambda name, fn, ptrs, ints: calls.append(ints))
    x, w = torch.ones(t, 8), torch.ones(2, 8, 4)
    seg = torch.tensor([0, t // 2, t])
    before = {k: c.count for k, c in gmm.TILING_LAUNCHES.items()}
    gmm._launch(x, w, seg, None, 2, -(-t // gmm.TILE_ROWS) + 2, torch.float32, "fma")
    tiling = gmm.fma_tiling(t)
    assert calls[0][-1] == gmm.FMA_TILINGS[tiling]
    assert {k: c.count - before[k] for k, c in gmm.TILING_LAUNCHES.items()} == {
        k: int(k == tiling) for k in gmm.FMA_TILINGS}


def _segments(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def rows_few_emulation(x, w, seg_rows, bn: int = 128):
    """The rows-few kernel's sums: a block per (segment, ``bn``-column
    slab), passes of RC = 8 rows; warp v owns k rows v*4 .. v*4+3 of every
    32-deep stage, lane sub of a column the rows sub + SUB i of those; a
    thread adds its k in stage order, then the lanes of a column (xor 16)
    and the warps 0..7 are added in order."""
    warps, kw, rc = 8, 4, 8
    bk, sub_n = kw * warps, 32 // (bn // 4)
    kt_n = kw // sub_n
    e, k, n = w.shape
    y = torch.zeros(x.shape[0], n)
    nk = -(-k // bk)
    wp = torch.nn.functional.pad(w, (0, 0, 0, nk * bk - k))      # zero k rows past K
    xp = torch.nn.functional.pad(x, (0, nk * bk - k))
    for s in range(e):
        r0, r1 = int(seg_rows[s]), int(seg_rows[s + 1])
        for p0 in range(r0, r1, rc):
            xs = xp[p0:min(p0 + rc, r1)]                 # the pass's rows
            # partial[v, sub]: warp v's and lane group sub's sum over its k
            partial = torch.zeros(warps, sub_n, xs.shape[0], n)
            for kt in range(nk):
                for i in range(kt_n):
                    for v in range(warps):
                        for sub in range(sub_n):
                            kk = kt * bk + v * kw + sub + sub_n * i
                            partial[v, sub] += xs[:, kk:kk + 1] * wp[s, kk][None, :]
            lanes = partial[:, 0] + partial[:, 1] if sub_n == 2 else partial[:, 0]
            acc = lanes[0]
            for v in range(1, warps):
                acc = acc + lanes[v]
            y[p0:p0 + xs.shape[0]] = acc
    return y


def tile_emulation(x, w, seg_rows):
    """The tile kernel's sums: every output of a 128-row tile summed over k
    in order (steps of BK, then kk within a step)."""
    e, k, n = w.shape
    y = torch.zeros(x.shape[0], n)
    for s in range(e):
        r0, r1 = int(seg_rows[s]), int(seg_rows[s + 1])
        for t0 in range(r0, r1, gmm.TILE_ROWS):
            rows = slice(t0, min(t0 + gmm.TILE_ROWS, r1))
            acc = torch.zeros(rows.stop - rows.start, n)
            for kk in range(k):
                acc += x[rows, kk:kk + 1] * w[s, kk][None, :]
            y[rows] = acc
    return y


GMM_CASES = [([37, 0, 9, 1, 0, 21], 33, 98), ([1] * 5, 40, 72), ([0, 0, 0], 16, 12),
             ([17, 0, 3], 17, 130), ([0, 5, 0, 12], 36, 1)]


def _hold_gmm(got, want):
    np.testing.assert_allclose(got, want, atol=GMM_F32_ATOL, rtol=GMM_F32_RTOL)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("sizes,k,n", GMM_CASES)
def test_rows_few_tiling_order_matches_plain(rng, sizes, k, n, bn):
    seg = _segments(sizes)
    x = torch.from_numpy(rng.standard_normal((int(seg[-1]) + 3, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(np.float32))
    got = rows_few_emulation(x, w, seg, bn)
    want = gmm.grouped_matmul_plain(x, w, torch.from_numpy(seg))
    t = int(seg[-1])
    _hold_gmm(got[:t].numpy(), want[:t].numpy())
    np.testing.assert_allclose(tile_emulation(x, w, seg)[:t].numpy(), want[:t].numpy(),
                               atol=GMM_F32_ATOL, rtol=GMM_F32_RTOL)


@pytest.mark.parametrize("sizes,k,n,bk,bn", [([37, 0, 9, 1], 64, 96, 32, 32),
                                             ([1, 1, 21, 0], 40, 72, 8, 24)])
def test_fma_tilings_match_pallas(rng, sizes, k, n, bk, bn):
    """Both tilings' orders against the reference's Pallas kernel in
    interpret mode on its padded layout (bt = 32: zero pad rows inside
    every segment's last tile)."""
    offs, tile_group, t_pad = ref_gmm.plan_groups(np.asarray(sizes), 32)
    x = np.zeros((t_pad, k), np.float32)
    for g, m in enumerate(sizes):
        x[offs[g]:offs[g] + m] = rng.standard_normal((m, k))
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    want = np.asarray(ref_gmm.grouped_matmul_padded(jnp.asarray(x), jnp.asarray(w),
                                                    jnp.asarray(tile_group), bt=32, bn=bn,
                                                    bk=bk, interpret=True))
    seg = np.arange(0, t_pad + 1, 32, dtype=np.int64)
    wt = torch.from_numpy(w)[torch.from_numpy(tile_group).long()]   # a w per tile
    xt = torch.from_numpy(x)
    for got in (rows_few_emulation(xt, wt, seg), rows_few_emulation(xt, wt, seg, 64),
                tile_emulation(xt, wt, seg)):
        _hold_gmm(got.numpy(), want)


# -- the prefill kernel -------------------------------------------------------

def _xor_tree_sum(parts):
    """The 16 threads' partial sums of a row added by __shfl_xor_sync over
    offsets 8, 4, 2, 1 (the value every lane ends with)."""
    for off in (8, 4, 2, 1):
        parts = parts + parts[..., torch.arange(16) ^ off]
    return parts[..., 0]


def flash_fma_emulation(q, k, v, window: int = 0):
    """The fma prefill kernel's sums, block by block (batch and KV heads at
    once): row r of a block is position q0 + r // g of head hk g + r % g;
    S over d in steps of 4; thread (tr, tc) holds rows 4 tr + i and keys
    tc + 16 j of a tile; each tile rescales by the row max over the tile's
    16 threads."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    rows, bk = 64, 64
    bq = rows // g
    scale = 1.0 / (d ** 0.5)
    out = torch.zeros_like(q)
    r = torch.arange(rows)
    nk = -(-s // bk)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * bk - s)).permute(0, 2, 1, 3)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * bk - s)).permute(0, 2, 1, 3)
    for qt in range(-(-s // bq)):
        q0 = qt * bq
        qpos = q0 + r // g
        active = (r < bq * g) & (qpos < s)
        heads = torch.arange(hkv)[:, None] * g + (r % g)[None, :]           # [hkv, rows]
        qb = q[:, qpos.clamp(max=s - 1)][:, torch.arange(rows)[None, :], heads]  # [b,hkv,rows,d]
        qb = torch.where(active[None, None, :, None], qb, 0.0)
        m = torch.full((b, hkv, rows), NEG_INF)
        l_part = torch.zeros(b, hkv, rows, 16)
        acc = torch.zeros(b, hkv, rows, d)
        q_last = min(q0 + bq, s) - 1
        kt_lo = max(q0 - window + 1, 0) // bk if window > 0 else 0
        for kt in range(kt_lo, q_last // bk + 1):
            k0 = kt * bk
            kb, vb = kp[:, :, k0:k0 + bk], vp[:, :, k0:k0 + bk]
            sc = torch.zeros(b, hkv, rows, bk)
            for d0 in range(0, d, 4):
                sc = sc + qb[..., d0:d0 + 4] @ kb[..., d0:d0 + 4].transpose(-1, -2)
            kpos = k0 + torch.arange(bk)
            visible = ((kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < s))
            if window > 0:
                visible &= qpos[:, None] - kpos[None, :] < window
            sc = torch.where(visible, sc * scale, NEG_INF)
            # key tc + 16 j of thread tc: [.., rows, j, tc]
            st = sc.reshape(b, hkv, rows, 4, 16)
            mx = st.amax(dim=(-1, -2))
            m_new = torch.maximum(m, mx)
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new[..., None, None])
            rs = ((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]) + p[..., 3, :]
            l_part = l_part * alpha[..., None] + rs
            m = m_new
            acc = acc * alpha[..., None]
            pk = p.reshape(b, hkv, rows, bk)
            for j in range(bk):
                acc = acc + pk[..., j:j + 1] * vb[:, :, j][:, :, None, :]
        o = acc / torch.clamp_min(_xor_tree_sum(l_part), 1e-30)[..., None]
        for rr in torch.nonzero(active).flatten().tolist():
            out[:, q0 + rr // g, torch.arange(hkv) * g + rr % g] = o[:, :, rr]
    return out


def _qkv(rng, b, s, h, hkv, d):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3, 4, 8, 9])
def test_flash_fma_order_matches_plain_and_pallas(rng, g, d, window):
    # S off the 64-key tile and off the block's bq = 64 // g positions
    q, k, v = _qkv(rng, 1, 100, 2 * g, 2, d)
    got = flash_fma_emulation(q, k, v, window)
    want = fp.flash_prefill_plain(q, k, v, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_F32_ATOL, rtol=0)
    # the reference needs S a multiple of its blocks
    q, k, v = (x[:, :96] for x in (q, k, v))
    ref = np.asarray(ref_ops.flash_prefill(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                           bq=32, bk=32, window=window, interpret=True))
    np.testing.assert_allclose(flash_fma_emulation(q, k, v, window).numpy(), ref,
                               atol=ATTN_F32_ATOL, rtol=0)


def test_flash_fma_masks_rows_with_no_visible_key_in_a_tile(rng):
    """A window shorter than a tile: rows whose first visible key lies in
    the next tile see only masked keys in the first (their exp(0) terms are
    rescaled away), and the block's last rows lie past S."""
    q, k, v = _qkv(rng, 2, 130, 4, 1, 64)
    got = flash_fma_emulation(q, k, v, window=5)
    want = fp.flash_prefill_plain(q, k, v, window=5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_F32_ATOL, rtol=0)
