"""The split-KV decode kernel and the dense slab's load paths, checked without a card.

No CUDA kernel runs here: these tests cover what the host decides and the
arithmetic the decode kernel was designed around. ``python3 chip_smoke.py``
on the card builds both kernels and holds them to their plain versions.

* (a) ``chunked_attention.choose_split``, the wrapper's split count, is a
  function of the shapes and the SM count alone (no ``lengths``): at the
  served shapes (Llama-3.2-1B and OLMoE-1B-7B decode steps) and the
  smoke's ragged shapes it fills at most ``BLOCKS_PER_SM`` blocks an SM
  (one wave), as many as fit unless a cap (``MAX_SPLIT``, one chunk a
  split) binds. ``_split_bounds`` states the share rule each block
  applies on the card.
* (b) A plain-torch emulation of the kernel's arithmetic: each split walks
  its share in ``BKV``-position chunks with an online softmax in f32 and
  an explicit visibility flag (so a split with no visible key keeps l = 0
  and m = NEG_INF), and the combine rescales live splits by exp(m_i - M)
  and gives l = 0 splits weight 0. On numpy-seeded inputs with lengths 0,
  1, fewer than n_split and S, at g 1, 4, 9 and D 64, 128, it is held to
  ``decode_attention_plain`` (f32 within ``ATTN_F32_ATOL``; bf16 within
  ``ATTN_BF16_ULPS`` ulps, the card's gates) and to the reference Pallas
  ``decode_attention`` in interpret mode under the same gates (rows of
  length 0 excluded: the reference divides 0 by 0 there). Without the l = 0 rule, at length 0
  every split's NEG_INF state takes weight exp(0) = 1 and the row becomes
  0 / 0.
* (c) ``ranged_spgemm.choose_path``: the float4 / cp.async path only for
  16-byte aligned operands whose ``k_pad``, ``span``, ``n`` and chunk
  starts are multiples of 4 floats (the main path's brick3d n=32
  quickstart staging), the masked scalar path otherwise (its chunk1
  staging: k_pad 42,043, span 9,275); CPU calls count no launch.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_BF16_ULPS, ATTN_F32_ATOL
from repro.kernels import ops as ref_ops
from repro_torch.kernels import chunked_attention as ca
from repro_torch.kernels import ranged_spgemm as rs

H100_SMS = 132
BF16, F32 = torch.bfloat16, torch.float32


def _split_bounds(length: int, n_split: int, s: int) -> list:
    """The ``[start, end)`` positions each split of one sequence takes, as
    ``decode_split_kernel`` computes them: ``ceil(len / n_split)`` rounded
    up to a chunk of ``BKV``, cut at the length (clamped to ``[0, s]``)."""
    length = min(max(int(length), 0), s)
    per_split = -(-length // n_split)
    share = -(-per_split // ca.BKV) * ca.BKV
    return [(min(i * share, length), min(i * share + share, length))
            for i in range(n_split)]


# ---------------------------------------------------------------------------
# (a) the split choice
# ---------------------------------------------------------------------------


def test_split_choice_reads_shapes_only():
    assert list(inspect.signature(ca.choose_split).parameters) == ["b", "hkv", "s", "n_sm"]
    assert list(inspect.signature(ca.device_split).parameters) == ["b", "hkv", "s", "device"]


@pytest.mark.parametrize("b,hkv,s,want", [
    (8, 8, 4096, 4),      # Llama-3.2-1B decode step: 256 blocks
    (8, 16, 4096, 2),     # OLMoE-1B-7B decode step: 256 blocks
    (4, 2, 300, 5),       # the smoke's ragged cases: one split a chunk
    (2, 1, 4096, 32),     # the few-live cases: MAX_SPLIT
    (32, 8, 4096, 1),     # the smoke's one-split case: 256 pairs, one block each
    (64, 8, 512, 1),      # more (sequence, head) pairs than the target
])
def test_split_choice_at_the_smoke_shapes(b, hkv, s, want):
    assert ca.choose_split(b, hkv, s, H100_SMS) == want


@pytest.mark.parametrize("n_sm", [132, 114, 80])
@pytest.mark.parametrize("b,hkv,s", [(8, 8, 4096), (8, 16, 4096), (4, 2, 300), (1, 8, 4096),
                                     (3, 5, 1000), (2, 1, 4096), (64, 8, 512), (1, 1, 64),
                                     (7, 3, 0)])
def test_split_choice_fills_one_wave(b, hkv, s, n_sm):
    n = ca.choose_split(b, hkv, s, n_sm)
    target = ca.BLOCKS_PER_SM * n_sm
    chunks = -(-s // ca.BKV)
    assert 1 <= n <= ca.MAX_SPLIT and n <= max(chunks, 1)
    # one wave at most (unless a single split already exceeds it) ...
    assert b * hkv * n <= target or n == 1
    # ... and as many splits as fit, unless a cap binds
    assert b * hkv * (n + 1) > target or n in (ca.MAX_SPLIT, max(chunks, 1))


@pytest.mark.parametrize("length,n_split,s", [(1953, 4, 4096), (0, 5, 300), (1, 5, 300),
                                              (3, 32, 4096), (300, 5, 300), (4096, 32, 4096),
                                              (65, 2, 128), (5000, 3, 4096)])
def test_split_bounds_share_rule(length, n_split, s):
    """The kernel's share rule has the properties its design relies on: the
    splits tile [0, len) in order, each live split but the last holds a
    whole number of chunks (so every chunk a block walks starts at a
    visible position), and length 1 leaves exactly one live split."""
    bounds = _split_bounds(length, n_split, s)
    live = min(max(length, 0), s)
    assert len(bounds) == n_split
    # contiguous, in order, covering exactly [0, live)
    assert bounds[0][0] == 0 and bounds[-1][1] == live
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    shares = [e - a for a, e in bounds]
    per_split = -(-live // n_split)
    share = -(-per_split // ca.BKV) * ca.BKV
    # the live splits come first, each a whole share but the last
    live_shares = [x for x in shares if x > 0]
    assert shares[:len(live_shares)] == live_shares
    assert all(x == share for x in live_shares[:-1]) and all(x <= share for x in live_shares)
    assert share % ca.BKV == 0
    if live == 1:   # length 1: exactly one live split
        assert live_shares == [1]


# ---------------------------------------------------------------------------
# (b) split + combine, emulated
# ---------------------------------------------------------------------------


def _split_state(q, k, v, start, end, scale):
    """One split: BKV-position chunks of [start, end), online softmax in
    f32 with an explicit visibility flag. q [G, D], k and v [S, D] (f32)."""
    g, d = q.shape
    m = torch.full((g,), ca.NEG_INF)
    l = torch.zeros(g)
    acc = torch.zeros(g, d)
    for p0 in range(start, end, ca.BKV):
        pos = torch.arange(p0, p0 + ca.BKV)
        live = pos < end
        rows = pos.clamp(max=k.shape[0] - 1)
        s = (q @ k[rows].T) * scale                         # [G, BKV]
        mx = torch.where(live, s, ca.NEG_INF).amax(-1)
        m_new = torch.maximum(m, mx)
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[:, None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + p @ torch.where(live[:, None], v[rows], 0.0)
        m = m_new
    return m, l, acc


def _emulate(q, k, v, lengths, n_split, *, naive_combine=False):
    """The kernel's split + combine in plain torch; q [B, Hkv, G, D], k and
    v [B, S, Hkv, D], any float dtype (the sums in f32). ``naive_combine``
    weights every split by exp(m_i - M) and divides without a guard."""
    b, hkv, g, d = q.shape
    s = k.shape[1]
    scale = 1.0 / d ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        bounds = _split_bounds(int(lengths[bi]), n_split, s)
        for h in range(hkv):
            states = [_split_state(qf[bi, h], kf[bi, :, h], vf[bi, :, h], a, e, scale)
                      for a, e in bounds]
            m = torch.stack([st[0] for st in states])        # [n_split, G]
            l = torch.stack([st[1] for st in states])
            acc = torch.stack([st[2] for st in states])      # [n_split, G, D]
            if naive_combine:
                w = torch.exp(m - m.amax(0))
                out[bi, h] = (w[..., None] * acc).sum(0) / (w * l).sum(0)[:, None]
                continue
            live = l > 0
            mm = torch.where(live, m, ca.NEG_INF).amax(0)
            w = torch.where(live, torch.exp(m - mm), 0.0)
            lt = (w * l).sum(0)
            o = (w[..., None] * acc).sum(0)
            out[bi, h] = torch.where(lt[:, None] > 0, o / lt.clamp_min(1e-30)[:, None], 0.0)
    return out.to(q.dtype)


def _inputs(seed, b, hkv, g, d, s):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d))]


def _assert_gate(got, want):
    """The card's gates: f32 within ATTN_F32_ATOL; bf16 within
    ATTN_BF16_ULPS ulps of the plain value (plus the f32 atol)."""
    got32, want32 = got.float(), want.float()
    diff = (got32 - want32).abs()
    if got.dtype == BF16:
        ulp = torch.exp2(torch.floor(torch.log2(want32.abs().clamp_min(1e-30))) - 7)
        assert bool((diff <= ATTN_BF16_ULPS * ulp + ATTN_F32_ATOL).all()), float(diff.max())
    else:
        assert float(diff.max()) <= ATTN_F32_ATOL


S_EMU, BS_KV = 320, 64
LENGTHS = [0, 1, 3, S_EMU]   # empty, one key, fewer keys than splits, the whole cache


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g,d", [(1, 64), (4, 64), (9, 64), (1, 128), (4, 128), (9, 128)])
def test_split_combine_matches_plain_and_reference(g, d, dtype):
    b, hkv = len(LENGTHS), 2
    n_split = ca.choose_split(b, hkv, S_EMU, H100_SMS)
    assert n_split == 5 and min(n for n in LENGTHS if n) < n_split
    q, k, v = _inputs(100 + 10 * g + d, b, hkv, g, d, S_EMU)
    lengths = np.asarray(LENGTHS, np.int32)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tl = torch.from_numpy(lengths)
    got = _emulate(tq, tk, tv, tl, n_split)
    _assert_gate(got, ca.decode_attention_plain(tq, tk, tv, tl))
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0: zeros

    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = torch.from_numpy(np.array(
        ref_ops.decode_attention(jq, jk, jv, jnp.asarray(lengths), bs_kv=BS_KV,
                                 interpret=True), np.float32))
    live = torch.from_numpy(lengths > 0)
    _assert_gate(got[live], want[live])


@pytest.mark.parametrize("n_split", [1, 2, 7, 32])
def test_split_combine_any_split_count(n_split):
    """The function does not depend on the split count (1 writes acc / l
    directly on the card; 32 leaves most splits empty)."""
    q, k, v = _inputs(7, 3, 2, 4, 64, 4096)
    lengths = torch.tensor([4096, 100, 1], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _assert_gate(_emulate(tq, tk, tv, lengths, n_split),
                 ca.decode_attention_plain(tq, tk, tv, lengths))


def test_empty_splits_must_get_weight_zero():
    """An empty split's state is (NEG_INF, 0, 0). With no live split at all
    (length 0) the row's max M is NEG_INF too, and a combine that weights
    every split by exp(m_i - M) gives each weight exp(0) = 1 and divides
    0 by 0. The kernel's rule (l = 0 splits get weight 0, a row with no
    weight gets zeros) keeps that row at zeros; every split but one is
    empty in the other row, which both combines get right."""
    q, k, v = _inputs(8, 2, 1, 4, 64, 4096)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lengths = torch.tensor([0, 2], dtype=torch.int32)
    want = ca.decode_attention_plain(tq, tk, tv, lengths)
    got = _emulate(tq, tk, tv, lengths, 32)
    _assert_gate(got, want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    naive = _emulate(tq, tk, tv, lengths, 32, naive_combine=True)
    assert torch.isnan(naive[0]).all()
    _assert_gate(naive[1:], want[1:])


# ---------------------------------------------------------------------------
# (c) the dense slab's load path
# ---------------------------------------------------------------------------


def _shaped(*shape, offset=0):
    """A tensor of ``shape`` over a 4-float storage (shape only matters),
    starting ``offset`` floats into it."""
    return torch.zeros(8).as_strided(shape, (0,) * len(shape), offset)


@pytest.mark.parametrize("k_pad,span,n,r0s,offset,want", [
    (65536, 32768, 4096, [0], 0, "vec"),                          # brick3d32 quickstart
    (42043, 9275, 4096, [0, 9275, 18550, 27825], 0, "scalar"),   # brick3d32 chunk1_c0
    (1024, 512, 640, [0, 512], 0, "vec"),
    (1023, 512, 640, [0, 508], 0, "scalar"),                      # k_pad off 4
    (1024, 510, 640, [0, 512], 0, "scalar"),                      # span off 4
    (1024, 512, 638, [0, 512], 0, "scalar"),                      # n off 4
    (1024, 512, 640, [0, 511], 0, "scalar"),                      # a chunk start off 4
    (1024, 512, 640, [0, 512], 1, "scalar"),                      # operands off 16 bytes
])
def test_dense_path_choice(k_pad, span, n, r0s, offset, want):
    a = _shaped(1, 2, 3, k_pad, offset=offset)
    slabs = _shaped(1, len(r0s), span, n, offset=offset)
    c0 = _shaped(1, 2, 3, n, offset=offset)
    assert rs.choose_path(a, slabs, c0, r0s) == want
    assert rs.choose_path(a, slabs, c0, torch.tensor(r0s, dtype=torch.int32)) == want


def test_dense_cpu_calls_count_no_launch():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((1, 2, 5, 12)).astype(np.float32))
    slabs = torch.from_numpy(rng.standard_normal((1, 2, 4, 6)).astype(np.float32))
    c0 = torch.zeros(1, 2, 5, 6)
    before = {p: c.count for p, c in rs.PATH_LAUNCHES.items()}
    total = rs.LAUNCHES.count
    for order in rs.ORDERS:
        out = rs.ranged_spgemm_stream(a, slabs, c0, [0, 8], order=order)
        assert torch.equal(out, rs.ranged_spgemm_plain(a, slabs, c0, [0, 8], order=order))
    assert {p: c.count for p, c in rs.PATH_LAUNCHES.items()} == before
    assert rs.LAUNCHES.count == total
