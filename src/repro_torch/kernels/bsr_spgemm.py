"""BSR x BSR SpGEMM: host symbolic phase, CUDA numeric kernel, plain version.

The port of the JAX package's ``kernels/bsr_spgemm.py``. The symbolic phase
(:func:`bsr_spgemm_symbolic`, host NumPy) is KKMEM's compression in block
form: C's block structure is the union of B's block-rows selected by A's
block-columns, and every C block gets a row of contributor slot pairs, padded
with the zero-sentinel slots (index ``nbl_pad`` of each operand, the block
:func:`repro_torch.sparse.bsr.bsr_blocks_with_sentinel` appends).

:func:`bsr_spgemm_blocks` is the numeric phase: on the card the CUDA kernel
``csrc/bsr_spgemm.cu``, on the CPU :func:`bsr_spgemm_plain`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.sparse.bsr import BSR
from repro_torch.sparse.csr import _np

LAUNCHES = LaunchCounter()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class BsrSpgemmMeta:
    """Host-computed symbolic structure of C = A x B at block granularity."""

    c_indptr: np.ndarray     # int32[mb + 1]
    c_indices: np.ndarray    # int32[nc_pad]
    a_slots: np.ndarray      # int32[nc_pad, U]  (zero-sentinel = A's appended zero block)
    b_slots: np.ndarray      # int32[nc_pad, U]
    n_c_blocks: int
    nc_pad: int
    u_max: int
    flops: int               # 2 * bs^3 * total contributor pairs


def bsr_spgemm_symbolic(A: BSR, B: BSR, pad_multiple: int = 8,
                        nc_pad: int | None = None,
                        u_max: int | None = None) -> BsrSpgemmMeta:
    """Block-level symbolic phase: structure of C and contributor slot tables.

    ``nc_pad`` / ``u_max``, when given, are envelope-level *floors* (from
    ``repro_torch.core.symbolic.bsr_plan_caps``): the tables are shaped to
    them, and a realized structure exceeding a floor raises ``ValueError``
    (the kernel would otherwise drop contributor pairs or C blocks)."""
    a_ptr = _np(A.block_indptr).astype(np.int64)
    a_idx = _np(A.block_indices).astype(np.int64)
    b_ptr = _np(B.block_indptr).astype(np.int64)
    b_idx = _np(B.block_indices).astype(np.int64)
    mb = A.mb
    n_a = int(a_ptr[-1])
    a_rows = np.repeat(np.arange(mb, dtype=np.int64), a_ptr[1:] - a_ptr[:-1])
    a_cols = a_idx[:n_a]
    a_slot = np.arange(n_a, dtype=np.int64)
    # fan each A block out over B's block-row a_cols[s]
    lens = b_ptr[a_cols + 1] - b_ptr[a_cols]
    total = int(lens.sum())
    cum = np.concatenate([[0], np.cumsum(lens)])
    p = np.arange(total, dtype=np.int64)
    t = np.searchsorted(cum, p, side="right") - 1
    pos_in_row = p - cum[t]
    pair_a_slot = a_slot[t]
    pair_b_slot = b_ptr[a_cols[t]] + pos_in_row
    pair_i = a_rows[t]
    pair_j = b_idx[pair_b_slot]
    # group pairs by C block (i, j)
    key = pair_i * np.int64(B.nb) + pair_j
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    counts = np.diff(np.concatenate([start, [total]]))
    n_c = int(uniq.size)
    u = int(counts.max()) if n_c else 1
    if u_max is None:
        u_max = u
    elif u > u_max:
        raise ValueError(
            f"u_max={u_max} < realized contributor count {u}: the envelope's "
            f"block caps do not dominate this instance — rebuild the envelope "
            f"(bsr_plan_caps) from the instances it serves")
    if nc_pad is None:
        nc_pad = -(-max(n_c, 1) // pad_multiple) * pad_multiple
    elif n_c > nc_pad:
        raise ValueError(
            f"nc_pad={nc_pad} < realized C block count {n_c}: the envelope's "
            f"block caps do not dominate this instance — rebuild the envelope "
            f"(bsr_plan_caps) from the instances it serves")
    a_zero, b_zero = A.nbl_pad, B.nbl_pad  # appended zero-block slots
    a_tab = np.full((nc_pad, u_max), a_zero, np.int32)
    b_tab = np.full((nc_pad, u_max), b_zero, np.int32)
    grp = np.repeat(np.arange(n_c), counts)
    col = p - np.repeat(start, counts)  # position within group (pairs are sorted)
    a_tab[grp, col] = pair_a_slot[order].astype(np.int32)
    b_tab[grp, col] = pair_b_slot[order].astype(np.int32)
    c_i = (uniq // B.nb).astype(np.int64)
    c_j = (uniq % B.nb).astype(np.int32)
    c_indptr = np.zeros(mb + 1, np.int64)
    np.add.at(c_indptr, c_i + 1, 1)
    c_indptr = np.cumsum(c_indptr).astype(np.int32)
    c_indices = np.zeros(nc_pad, np.int32)
    c_indices[:n_c] = c_j
    # padding invariants consumers rely on: c_indptr spans exactly the n_c
    # real blocks, and padding table rows are all-sentinel (they MAC nothing)
    assert int(c_indptr[-1]) == n_c, (c_indptr[-1], n_c)
    assert (a_tab[n_c:] == a_zero).all() and (b_tab[n_c:] == b_zero).all()
    return BsrSpgemmMeta(
        c_indptr=c_indptr, c_indices=c_indices, a_slots=a_tab, b_slots=b_tab,
        n_c_blocks=n_c, nc_pad=nc_pad, u_max=u_max,
        flops=2 * (A.block_size ** 3) * total,
    )


def bsr_spgemm_plain(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                     a_slots: torch.Tensor, b_slots: torch.Tensor, nc_pad: int,
                     u_max: int, bs: int, skip_zero: bool = True) -> torch.Tensor:
    """Plain version: for every contributor step u, the batched product of
    the gathered block pairs, added in f32 into each C block's tile; steps on
    the zero-sentinel A slot add nothing (skipped, or a zero tile)."""
    a_zero = a_blocks.shape[0] - 1
    out = torch.zeros(nc_pad, bs, bs, dtype=torch.float32, device=a_blocks.device)
    a32, b32 = a_blocks.float(), b_blocks.float()
    for u in range(u_max):
        sa, sb = a_slots[:, u].long(), b_slots[:, u].long()
        prod = torch.bmm(a32[sa], b32[sb])
        if skip_zero:
            prod = torch.where((sa != a_zero)[:, None, None], prod, 0.0)
        out += prod
    return out


def bsr_spgemm_blocks(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                      a_slots, b_slots, nc_pad: int, u_max: int, bs: int,
                      skip_zero: bool = True) -> torch.Tensor:
    """``out[e] = sum_u A_blk[a_slots[e, u]] @ B_blk[b_slots[e, u]]`` in f32,
    shape ``[nc_pad, bs, bs]``. ``a_blocks``/``b_blocks`` must already carry
    the appended zero block (shapes ``(nbl_pad + 1, bs, bs)``), f32 or bf16.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = a_blocks.device
    a_slots = torch.as_tensor(a_slots, dtype=torch.int32).to(dev).contiguous()
    b_slots = torch.as_tensor(b_slots, dtype=torch.int32).to(dev).contiguous()
    if tuple(a_slots.shape) != (nc_pad, u_max) or a_slots.shape != b_slots.shape:
        raise ValueError(f"slot tables {tuple(a_slots.shape)}, "
                         f"{tuple(b_slots.shape)} != ({nc_pad}, {u_max})")
    for t, what in ((a_blocks, "a_blocks"), (b_blocks, "b_blocks")):
        if t.dim() != 3 or t.shape[1:] != (bs, bs):
            raise ValueError(f"{what} shape {tuple(t.shape)} is not [n, {bs}, {bs}]")
    if dev.type == "cpu":
        return bsr_spgemm_plain(a_blocks, b_blocks, a_slots, b_slots, nc_pad,
                                u_max, bs, skip_zero)
    if a_blocks.dtype not in _DTYPES or b_blocks.dtype != a_blocks.dtype:
        raise ValueError(f"blocks must share a dtype in {list(_DTYPES)}, got "
                         f"{a_blocks.dtype} and {b_blocks.dtype}")
    if not 1 <= bs <= 32:
        raise ValueError(f"block size {bs} outside the kernel's 1..32")
    for t, what in ((a_blocks, "a_blocks"), (b_blocks, "b_blocks")):
        require(t, what, a_blocks.dtype, dev)
    out = torch.empty(nc_pad, bs, bs, dtype=torch.float32, device=dev)
    launch("bsr_spgemm", "bsr_spgemm_launch",
           [a_blocks, b_blocks, a_slots, b_slots, out],
           [nc_pad, u_max, bs, a_blocks.shape[0] - 1, int(skip_zero),
            _DTYPES[a_blocks.dtype]])
    LAUNCHES.bump()
    return out
