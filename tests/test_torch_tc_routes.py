"""The routes of the bf16 tensor-core kernels, checked without a card.

No CUDA kernel runs here: these tests cover what the host decides and the
arithmetic a kernel was designed around. ``python3 chip_smoke.py`` on the
card builds the routes and holds each to its plain version.

* (a) The route each wrapper takes on the card comes from a plain host
  function: ``flash_prefill.choose_route`` (bf16 -> ``"tc"``, f32 ->
  ``"fma"``) and ``grouped_matmul.choose_route`` (bf16 in and out, K and N
  modulo 8, alignment, and the row count against ``SMALL_ROWS_MAX``; every
  other case, bf16 to an f32 output included, goes to ``"fma"``); each
  route has a launch counter of its own.
* (b) The tensor-core prefill kernel multiplies V by P split into
  ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``. A plain-torch emulation
  of its online softmax (64-key tiles, bf16 inputs) with that split stays
  within ``chip_smoke.py``'s bf16 gate (``ATTN_BF16_ULPS`` ulps plus
  ``ATTN_F32_ATOL``) of ``flash_prefill_plain``; with P rounded once to
  bf16 it does not.
* (c) The ragged entry refuses an unknown route and a route the operands do
  not fit, on any device; the padded entries take no route; CPU tensors
  take the plain versions on every route that fits, and count no launch.
"""

import inspect

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_BF16_ULPS, ATTN_F32_ATOL
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops

TILE = 64          # keys of one K/V tile of the tensor-core prefill kernel
BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# (a) the route choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,route", [(BF16, "tc"), (F32, "fma")])
def test_prefill_route(dtype, route):
    assert fp.choose_route(dtype) == route


@pytest.mark.parametrize("dtype,out,k,n,t,aligned,route", [
    (F32, F32, 2048, 1024, 64, True, "fma"),          # f32: no exact tensor-core mode
    (F32, F32, 2048, 1024, 123_968, True, "fma"),
    (F32, BF16, 2048, 1024, 123_968, True, "fma"),
    (BF16, F32, 2048, 1024, 64, True, "fma"),         # an f32 output: no tensor-core route
    (BF16, F32, 2048, 1024, 123_968, True, "fma"),
    (BF16, BF16, 2048, 1024, 64, True, "small"),      # the OLMoE decode shape (w1, w3)
    (BF16, BF16, 1024, 2048, 64, True, "small"),      # w2 at decode
    (BF16, BF16, 2048, 1024, 123_968, True, "tile"),  # the OLMoE prefill shape
    (BF16, BF16, 1024, 2048, 123_968, True, "tile"),
    (BF16, BF16, 17, 128, 64, True, "fma"),           # K off the 16-byte chunks
    (BF16, BF16, 16, 12, 64, True, "fma"),            # N off them
    (BF16, BF16, 33, 1, 300, True, "fma"),            # both
    (BF16, BF16, 40, 72, 8, True, "small"),
    (BF16, BF16, 2048, 1024, 64, False, "fma"),       # x or w misaligned
    (BF16, BF16, 2048, 1000, gmm.SMALL_ROWS_MAX, True, "small"),
    (BF16, BF16, 2048, 1000, gmm.SMALL_ROWS_MAX + 1, True, "tile"),
])
def test_grouped_matmul_route(dtype, out, k, n, t, aligned, route):
    assert gmm.choose_route(dtype, out, k, n, t, aligned) == route


def test_every_route_has_its_own_counter():
    assert set(fp.ROUTE_LAUNCHES) == set(fp.ROUTES) == {"tc", "fma"}
    assert set(gmm.ROUTE_LAUNCHES) == set(gmm.ROUTES) == {"tile", "small", "fma"}
    assert sorted(gmm.ROUTES.values()) == [0, 1, 2]    # the C entry's route codes
    for mod in (fp, gmm):
        counters = list(mod.ROUTE_LAUNCHES.values())
        assert len({id(c) for c in counters}) == len(counters)
        assert all(c is not mod.LAUNCHES for c in counters)


# ---------------------------------------------------------------------------
# (b) the P hi/lo split of the tensor-core prefill kernel, emulated
# ---------------------------------------------------------------------------


def emulate_tc_prefill(q, k, v, window: int, split: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain torch: 64-key tiles,
    f32 scores of bf16 operands, the finite NEG_INF mask, an f32 online
    softmax, and P V with P as ``P_hi + P_lo`` (``split``) or one bf16
    rounding of P, each product exact in f32, summed in f32."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, s, hkv, g, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s)
    m = torch.full((b, hkv, g, s), fp.NEG_INF)
    l = torch.zeros((b, hkv, g, s))
    acc = torch.zeros((b, hkv, g, s, d))
    for k0 in range(0, s, TILE):
        kpos = pos[k0:k0 + TILE]
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + TILE]) * scale
        mask = kpos[None, :] <= pos[:, None]
        if window:
            mask = mask & (pos[:, None] - kpos[None, :] < window)
        sc = torch.where(mask, sc, fp.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", part, vf[:, k0:k0 + TILE])
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def within_bf16_gate(got, want) -> bool:
    """``chip_smoke.py``'s bf16 check of the attention kernels."""
    got32, want32 = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want32.abs().clamp_min(1e-30))) - 7)
    return bool(((got32 - want32).abs() <= ATTN_BF16_ULPS * ulp + ATTN_F32_ATOL).all())


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("g,d", [(1, 64), (4, 64), (9, 128)])
def test_p_split_keeps_the_bf16_gate(g, d, window):
    rng = np.random.default_rng(150 + 10 * g + window + d)
    b, s, hkv = 2, 150, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
               for shape in ((b, s, g * hkv, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = fp.flash_prefill_plain(q, k, v, window=window)
    assert within_bf16_gate(emulate_tc_prefill(q, k, v, window, split=True), want)
    assert not within_bf16_gate(emulate_tc_prefill(q, k, v, window, split=False), want)


# ---------------------------------------------------------------------------
# (c) refusals, the entries' parameters, and the plain versions on the CPU
# ---------------------------------------------------------------------------


def test_prefill_refuses_what_no_route_takes():
    for dtype, d in ((torch.float16, 64), (BF16, 16), (F32, 96)):
        q = torch.zeros(1, 8, 4, d, dtype=dtype, device="meta")
        k = torch.zeros(1, 8, 2, d, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="kernel takes"):
            fp.flash_prefill(q, k, k)


def _gmm_operands(dtype, k, n, offset=0):
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal(16 * k + offset).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((2, k, n)).astype(np.float32)).to(dtype)
    return x[offset:].view(16, k), w, torch.tensor([0, 8, 16])


@pytest.mark.parametrize("route", ["tile", "small"])
@pytest.mark.parametrize("dtype,out,k,n,offset", [
    (F32, None, 64, 64, 0),       # f32 operands
    (BF16, F32, 64, 64, 0),       # bf16 to an f32 output
    (BF16, None, 17, 64, 0),      # K = 17
    (BF16, None, 64, 12, 0),      # N off a multiple of 8
    (BF16, None, 64, 64, 1),      # x 2 bytes past a 16-byte boundary
])
def test_ragged_refuses_a_tensor_core_route_off_its_operands(route, dtype, out, k, n,
                                                             offset):
    x, w, seg = _gmm_operands(dtype, k, n, offset)
    with pytest.raises(ValueError, match=f"the {route} route takes"):
        gmm.grouped_matmul_ragged(x, w, seg, out, route=route)
    # the same operands are fine with the route left to choose_route
    assert gmm.grouped_matmul_ragged(x, w, seg, out).shape == (16, n)


def test_ragged_refuses_unknown_routes():
    x, w, seg = _gmm_operands(BF16, 16, 16)
    for route in ("mma", "tc", "TILE", ""):
        with pytest.raises(ValueError, match="is not one of"):
            gmm.grouped_matmul_ragged(x, w, seg, route=route)


def test_only_the_ragged_kernel_entry_takes_a_route():
    assert "route" in inspect.signature(gmm.grouped_matmul_ragged).parameters
    for entry in (gmm.grouped_matmul_padded, ops.grouped_matmul, ops.grouped_matmul_ragged,
                  fp.flash_prefill, ops.flash_prefill):
        assert "route" not in inspect.signature(entry).parameters, entry.__name__
    x, w, _ = _gmm_operands(BF16, 16, 16)
    with pytest.raises(TypeError):
        gmm.grouped_matmul_padded(x, w, [0, 1], bt=8, bk=8, bn=8, route="tile")


@pytest.mark.parametrize("dtype,out,routes", [
    (BF16, None, [None, "tile", "small", "fma"]),
    (BF16, F32, [None, "fma"]),
    (F32, None, [None, "fma"]),
])
def test_cpu_tensors_take_the_plain_grouped_matmul(dtype, out, routes):
    rng = np.random.default_rng(7)
    sizes = [5, 0, 9, 1]
    x = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((4, 16, 24)).astype(np.float32)).to(dtype)
    seg = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]))
    before = {r: c.count for r, c in gmm.ROUTE_LAUNCHES.items()}
    want = gmm.grouped_matmul_plain(x, w, seg, out_dtype=out)
    for route in routes:
        got = gmm.grouped_matmul_ragged(x, w, seg, out, route=route)
        assert got.dtype == (out or dtype)
        assert torch.equal(got, want)
    assert {r: c.count for r, c in gmm.ROUTE_LAUNCHES.items()} == before


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_tensors_take_the_plain_prefill(dtype):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((1, 40, 4, 64), (1, 40, 2, 64), (1, 40, 2, 64)))
    before = {r: c.count for r, c in fp.ROUTE_LAUNCHES.items()}
    got = fp.flash_prefill(q, k, v, window=16)
    assert torch.equal(got, fp.flash_prefill_plain(q, k, v, window=16))
    assert {r: c.count for r, c in fp.ROUTE_LAUNCHES.items()} == before
