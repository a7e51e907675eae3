"""Ragged grouped GEMM: the MoE expert compute, ``y[t] = x[t] @ w[g(t)]``.

The port of the JAX package's ``kernels/grouped_matmul.py``. The rows of x
come in segments, each of one group: segment s is rows ``[seg_rows[s],
seg_rows[s + 1])`` of x and y, multiplied by ``w[seg_group[s]]``. Two
entries launch a kernel of ``csrc/grouped_matmul.cu`` on the card, by the
route :func:`choose_route` picks, and run :func:`grouped_matmul_plain` on
the CPU:

* :func:`grouped_matmul_padded`, the reference's API: rows sorted by group
  and each group padded to a multiple of ``bt``, one group id per ``bt``-row
  tile (``tile_group``, from :func:`plan_groups` on the host). Every tile is
  a segment, so its zero pad rows give zero rows of y.
* :func:`grouped_matmul_ragged`, the model's entry: groups ``0..E-1`` in
  order, group g's rows ``[seg_rows[g], seg_rows[g + 1])`` with no padding,
  ``seg_rows`` a device tensor. It never reads ``seg_rows`` back to the host:
  the kernel's grid is sized by the bound ``ceil(T / TILE_ROWS) + E`` and
  blocks past the real tiles exit. Rows of y from ``seg_rows[E]`` on are not
  computed: the kernel leaves them unwritten and the plain version writes
  zeros.

Products and sums are f32 (a product of bf16 operands is exact in f32),
and y is rounded once to ``out_dtype`` (default x's dtype). The routes,
chosen from what the host knows without reading the card:

* ``"tile"``: bf16 x and w to a bf16 y, more than ``SMALL_ROWS_MAX`` rows
  (prefill: about 124k): 128 x 256 tiles of y on ``wgmma`` through a
  four-stage ``cp.async`` ring.
* ``"small"``: bf16 to bf16 with at most ``SMALL_ROWS_MAX`` rows (decode:
  64 rows, one to eight an expert): ``mma.sync`` with the operands swapped,
  each block streaming one expert's 128-column weight slab through a
  four-stage ``cp.async`` ring.
* ``"fma"``: everything else: f32 operands (the tensor cores have no
  f32-exact mode), an f32 output, K or N not a multiple of 8, or x or w not
  16-byte aligned (the other routes copy 16-byte chunks): f32 FMAs, by one
  of two tilings that :func:`fma_tiling` picks from the rows by the same
  ``SMALL_ROWS_MAX``: ``"rows_few"`` (decode), each block streaming one
  expert's 128-column weight slab once through a four-stage ``cp.async``
  ring for a segment's rows, or ``"tile"`` (prefill), 128 x 256 tiles of y
  with w arriving by ``cp.async`` through a three-stage ring.

Every route is right for every grouping; only the time differs.
``SMALL_ROWS_MAX`` = 512 lies between the two shapes the OLMoE serve path
sends, whose times on every route ``chip_smoke.py`` prints (numbers in
``PERF.md``). At prefill (T = 123,968) the small route, which re-reads an
expert's weight slab for every 32 rows, is about 5x slower than the tile
route. At decode (T = 64) it is faster: ``gmm_route_ablation.py`` times one
OLMoE decode step's 48 products by each route, alternated, and on an H100
80GB HBM3 at 700 W the small route's step median is 4.9% under the tile
route's (w2 10.5%, w1 and w3 1.8%), with every step faster. Between the two
shapes the value is a choice, not a measurement: at 512 rows over 64
experts a segment averages 8 rows, inside one of the small route's 32-row
passes, so it still reads each touched expert's weights about once.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._build import LaunchCounter, launch, require

LAUNCHES = LaunchCounter()                    # every launch of the kernel
ROUTES = {"tile": 1, "small": 2, "fma": 0}   # route -> the C entry's route argument
ROUTE_LAUNCHES = {r: LaunchCounter() for r in ROUTES}   # the launches of each route
# the fma route's two tilings -> the C entry's route argument, and the
# launches of each
FMA_TILINGS = {"tile": 0, "rows_few": 3}
TILING_LAUNCHES = {t: LaunchCounter() for t in FMA_TILINGS}
TILE_ROWS = 128      # rows of y a block of the tile and fma routes owns (BM)
SMALL_ROWS_MAX = 512   # rows of x at or below which bf16 takes the small route
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def choose_route(dtype: torch.dtype, out_dtype: torch.dtype, k: int, n: int, t: int,
                 aligned: bool = True) -> str:
    """The kernel a card call takes for x ``[t, k]`` in ``dtype`` by w
    ``[E, k, n]`` into y in ``out_dtype`` (``aligned``: x and w start on
    16-byte boundaries)."""
    if (dtype != torch.bfloat16 or out_dtype != torch.bfloat16 or k % 8 or n % 8
            or not aligned):
        return "fma"
    return "small" if t <= SMALL_ROWS_MAX else "tile"


def fma_tiling(t: int) -> str:
    """The fma route's tiling for x with ``t`` rows, by the small route's
    threshold: ``"rows_few"`` (a block streams one expert's weight slab
    once for a segment's rows) at or below ``SMALL_ROWS_MAX``, else
    ``"tile"`` (128-row tiles of y)."""
    return "rows_few" if t <= SMALL_ROWS_MAX else "tile"


def plan_groups(group_sizes, bt: int):
    """Host-side plan: padded offsets + per-tile group ids for ragged groups.

    Returns (padded_offsets[E+1], tile_group[T_pad//bt], t_pad)."""
    sizes = np.asarray(group_sizes, np.int64)
    padded = -(-sizes // bt) * bt
    offsets = np.concatenate([[0], np.cumsum(padded)])
    t_pad = int(offsets[-1])
    tile_group = np.repeat(np.arange(sizes.size, dtype=np.int32), padded // bt)
    return offsets.astype(np.int64), tile_group, max(t_pad, bt)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, seg_rows, seg_group=None,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: one f32 ``torch.matmul`` per segment, cast to
    ``out_dtype``; rows outside every segment are zeros. ``seg_rows`` and
    ``seg_group`` may live on the card (they are read back)."""
    bounds = torch.as_tensor(seg_rows).tolist()
    groups = (range(len(bounds) - 1) if seg_group is None
              else torch.as_tensor(seg_group).tolist())
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=out_dtype or x.dtype, device=x.device)
    for r0, r1, g in zip(bounds[:-1], bounds[1:], groups):
        if r1 > r0:
            y[r0:r1] = torch.matmul(x[r0:r1].float(), w[g].float()).to(y.dtype)
    return y


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: expected [T, K] "
                         "and [E, K, N]")


def _route(x, w, out_dtype, route: str | None) -> str:
    """:func:`choose_route`'s route, or ``route`` if the operands fit it."""
    auto = choose_route(x.dtype, out_dtype, w.shape[1], w.shape[2], x.shape[0],
                        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if route is None:
        return auto
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {tuple(ROUTES)}")
    if route != "fma" and auto == "fma":
        raise ValueError(f"the {route} route takes bf16 x and w, a bf16 output, K and N "
                         f"multiples of 8 and 16-byte aligned x and w; got {x.dtype} -> "
                         f"{out_dtype}, K={w.shape[1]}, N={w.shape[2]}")
    return route


def _launch(x, w, seg_rows, seg_group, n_seg: int, n_tiles: int, out_dtype,
            route: str) -> torch.Tensor:
    """The kernel on the card: operand checks, the output, one launch."""
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"the kernel takes f32/bf16 operands and output; got {x.dtype} "
                         f"-> {out_dtype}")
    for name, t in (("x", x), ("w", w)):
        require(t, name, x.dtype, x.device)
    require(seg_rows, "seg_rows", torch.int64, x.device)
    if seg_group is not None:
        require(seg_group, "seg_group", torch.int32, x.device)
    e, k, n = w.shape
    y = torch.empty((x.shape[0], n), dtype=out_dtype, device=x.device)
    tiling = fma_tiling(x.shape[0]) if route == "fma" else None
    code = FMA_TILINGS[tiling] if tiling else ROUTES[route]
    launch("grouped_matmul", "grouped_matmul_launch", [x, w, y, seg_rows, seg_group],
           [n_seg, n_tiles, k, n, e, _DTYPES[x.dtype], _DTYPES[out_dtype], code])
    LAUNCHES.bump()
    ROUTE_LAUNCHES[route].bump()
    if tiling:
        TILING_LAUNCHES[tiling].bump()
    return y


def grouped_matmul_ragged(x: torch.Tensor, w: torch.Tensor, seg_rows: torch.Tensor,
                          out_dtype: torch.dtype | None = None,
                          route: str | None = None) -> torch.Tensor:
    """x ``[T, K]`` with group g's rows at ``[seg_rows[g], seg_rows[g + 1])``
    (``seg_rows`` int64 ``[E + 1]``, ascending, ``seg_rows[E] <= T``), w
    ``[E, K, N]``; returns y ``[T, N]``. Nothing is read back to the host.
    ``route`` names the card route instead of :func:`choose_route`'s (so
    that every route can run on the same operands); one the operands do not
    fit raises, on any device."""
    _check_operands(x, w)
    if tuple(seg_rows.shape) != (w.shape[0] + 1,):
        raise ValueError(f"seg_rows {tuple(seg_rows.shape)} != ({w.shape[0] + 1},)")
    out_dtype = out_dtype or x.dtype
    route = _route(x, w, out_dtype, route)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, seg_rows, out_dtype=out_dtype)
    e = w.shape[0]
    n_tiles = -(-x.shape[0] // TILE_ROWS) + e
    return _launch(x, w, seg_rows, None, e, n_tiles, out_dtype, route)


def grouped_matmul_padded(x: torch.Tensor, w: torch.Tensor, tile_group,
                          bt: int = 128, bn: int = 128, bk: int = 128,
                          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: [T_pad, K] tokens sorted+padded by group; w: [E, K, N];
    tile_group: int32[T_pad // bt] group id per token tile. Returns [T_pad, N].

    The reference's divisibility rules hold; ``bn`` and ``bk`` are its Pallas
    block sizes and choose nothing here (the kernel tiles N and K itself)."""
    _check_operands(x, w)
    t_pad, kdim = x.shape
    e, _, ndim = w.shape
    if t_pad % bt or kdim % bk or ndim % bn:
        raise ValueError(f"shapes ({t_pad},{kdim},{ndim}) not divisible by tiles "
                         f"({bt},{bk},{bn})")
    tile_group = torch.as_tensor(tile_group)
    groups = tile_group.tolist()
    if tuple(tile_group.shape) != (t_pad // bt,) or not all(0 <= g < e for g in groups):
        raise ValueError(f"tile_group must hold {t_pad // bt} group ids in [0, {e})")
    seg_rows = torch.arange(0, t_pad + 1, bt, dtype=torch.int64, device=x.device)
    seg_group = tile_group.to(device=x.device, dtype=torch.int32)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, seg_rows, seg_group, out_dtype)
    n_tiles = len(groups) * -(-bt // TILE_ROWS)
    return _launch(x, w, seg_rows, seg_group, len(groups), n_tiles, out_dtype,
                   _route(x, w, out_dtype, None))
