"""BSR x dense SpMM (the paper's SpMM comparison point, Zheng et al. [24]).

The port of the JAX package's ``kernels/bsr_spmm.py``: ``Y = A_bsr @ X``
with X dense. :func:`bsr_spmm_symbolic` builds the per-block-row slot and
block-column tables (padding points at the appended zero block, column 0);
:func:`bsr_spmm_blocks` is the numeric phase: on the card the CUDA kernels
of ``csrc/bsr_spmm.cu``, on the CPU :func:`bsr_spmm_plain`.

On the card :func:`choose_path` picks one of two kernels from the shapes
alone. The ``group`` path (bs 4, 8 or 16, 128-column tiles, ``nf`` a
multiple of 4, 16-byte aligned operands) gives a block ``GROUP_WARPS``
consecutive block rows and stages each X slab their union of block columns
names once for all of them. It walks the union by merging the rows' own
slot and column tables in the kernel, so it is right for rows in any order
and builds no table of its own. The ``generic`` path (the first port)
takes every other shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.sparse.bsr import BSR
from repro_torch.sparse.csr import _np

LAUNCHES = LaunchCounter()
PATH_LAUNCHES = {"group": LaunchCounter(), "generic": LaunchCounter()}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_BLOCKS = (4, 8, 16)   # block sizes the group kernel is built for
GROUP_COLS = 128            # its output tile: 32 lanes x 4 columns
# block rows (warps) of a group block, kGroupWarps of csrc/bsr_spmm.cu (its
# C entry refuses another): the fastest of 1-12 at brick3d n=48
# (bsr_spmm_variant_ablation.py); larger groups reuse more X slabs but leave
# more warps without a block at each step
GROUP_WARPS = 2


@dataclasses.dataclass(frozen=True)
class BsrSpmmMeta:
    a_slots: np.ndarray   # int32[mb, U] -> index into A.blocks (zero sentinel = nbl_pad)
    a_cols: np.ndarray    # int32[mb, U] -> block-column of that slot (sentinel -> 0)
    u_max: int
    flops: int


def bsr_spmm_symbolic(A: BSR) -> BsrSpmmMeta:
    a_ptr = _np(A.block_indptr).astype(np.int64)
    a_idx = _np(A.block_indices).astype(np.int64)
    mb = A.mb
    lens = a_ptr[1:] - a_ptr[:-1]
    u_max = max(int(lens.max()) if mb else 1, 1)
    slots = np.full((mb, u_max), A.nbl_pad, np.int32)
    cols = np.zeros((mb, u_max), np.int32)
    # row i's blocks fill columns 0 .. lens[i] - 1 of its table row
    row = np.repeat(np.arange(mb), lens)
    pos = np.arange(int(a_ptr[-1])) - np.repeat(a_ptr[:-1], lens)
    slots[row, pos] = np.arange(int(a_ptr[-1]), dtype=np.int32)
    cols[row, pos] = a_idx[: int(a_ptr[-1])]
    return BsrSpmmMeta(a_slots=slots, a_cols=cols, u_max=u_max,
                       flops=2 * int(lens.sum()) * A.block_size ** 2)


def bsr_spmm_plain(a_blocks: torch.Tensor, x: torch.Tensor, a_slots: torch.Tensor,
                   a_cols: torch.Tensor, mb: int, u_max: int, bs: int) -> torch.Tensor:
    """Plain version: for every step u, each block row's gathered block times
    the X row slab its column names, added in f32 (the zero block adds 0)."""
    nf = x.shape[1]
    a32, x32 = a_blocks.float(), x.float().reshape(-1, bs, nf)
    out = torch.zeros(mb, bs, nf, dtype=torch.float32, device=x.device)
    for u in range(u_max):
        out += torch.bmm(a32[a_slots[:, u].long()], x32[a_cols[:, u].long()])
    return out.reshape(mb * bs, nf)


def choose_path(a_blocks: torch.Tensor, x: torch.Tensor, bs: int, bn: int) -> str:
    """The kernel a call takes, from shapes and addresses alone: ``"group"``
    for block sizes in ``GROUP_BLOCKS``, tiles of ``GROUP_COLS`` columns,
    ``nf`` a multiple of 4 (a lane's four columns are one 16- or 8-byte
    copy) and both operands on 16 bytes; else ``"generic"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (a_blocks, x))
    fits = bs in GROUP_BLOCKS and bn == GROUP_COLS and x.shape[1] % 4 == 0
    return "group" if fits and aligned else "generic"


def bsr_spmm_blocks(a_blocks: torch.Tensor, x: torch.Tensor, a_slots, a_cols,
                    mb: int, u_max: int, bs: int, bn: int) -> torch.Tensor:
    """``Y[mb * bs, nf] = A @ X`` in f32. ``a_blocks`` carries the appended
    zero block; ``bn`` is the width of one output column tile. CPU tensors
    take the plain version; CUDA tensors launch the kernel of
    :func:`choose_path`."""
    dev = x.device
    a_slots = torch.as_tensor(a_slots, dtype=torch.int32).to(dev).contiguous()
    a_cols = torch.as_tensor(a_cols, dtype=torch.int32).to(dev).contiguous()
    nf = x.shape[1]
    if tuple(a_slots.shape) != (mb, u_max) or a_cols.shape != a_slots.shape:
        raise ValueError(f"tables {tuple(a_slots.shape)}, {tuple(a_cols.shape)} "
                         f"!= ({mb}, {u_max})")
    if x.dim() != 2 or x.shape[0] % bs:
        raise ValueError(f"X shape {tuple(x.shape)} is not [k * {bs}, nf]")
    if dev.type == "cpu":
        return bsr_spmm_plain(a_blocks, x, a_slots, a_cols, mb, u_max, bs)
    if a_blocks.dtype not in _DTYPES or x.dtype != a_blocks.dtype:
        raise ValueError(f"blocks and X must share a dtype in {list(_DTYPES)}, "
                         f"got {a_blocks.dtype} and {x.dtype}")
    if not 1 <= bs <= 32 or bn < 1:
        raise ValueError(f"block size {bs} outside 1..32 or tile width {bn} < 1")
    require(a_blocks, "a_blocks", a_blocks.dtype, dev)
    require(x, "x", a_blocks.dtype, dev)
    y = torch.empty(mb * bs, nf, dtype=torch.float32, device=dev)
    _launch(a_blocks, x, a_slots, a_cols, y, mb, u_max, bs, bn)
    return y


def _launch(a_blocks, x, a_slots, a_cols, y, mb: int, u_max: int, bs: int, bn: int) -> str:
    """Launch the kernel of :func:`choose_path` into ``y`` and count it;
    returns the path."""
    path = choose_path(a_blocks, x, bs, bn)
    a_zero = a_blocks.shape[0] - 1
    dtype = _DTYPES[a_blocks.dtype]
    if path == "group":
        launch("bsr_spmm", "bsr_spmm_group_launch", [a_blocks, x, a_cols, a_slots, y],
               [mb, u_max, GROUP_WARPS, bs, x.shape[1], a_zero, dtype])
    else:
        launch("bsr_spmm", "bsr_spmm_launch", [a_blocks, x, a_slots, a_cols, y],
               [mb, u_max, bs, x.shape[1], bn, a_zero, dtype])
    PATH_LAUNCHES[path].bump()
    LAUNCHES.bump()
    return path

