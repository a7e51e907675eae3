"""Public wrappers around the BSR kernels: host-side symbolic planning
(NumPy), the zero-sentinel block appended, then the kernel (on the card) or
its plain version (on the CPU).

The port of the JAX package's ``kernels/ops.py`` for ``bsr_spgemm`` and
``bsr_spmm``; its LM-stack wrappers are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bsr_spgemm as _spgemm
from repro_torch.kernels import bsr_spmm as _spmm
from repro_torch.sparse.bsr import BSR


def _with_zero_block(blocks: torch.Tensor) -> torch.Tensor:
    """Append the guaranteed-zero sentinel block (slot index = old length)."""
    return torch.cat([blocks, blocks.new_zeros((1,) + tuple(blocks.shape[1:]))]).contiguous()


def bsr_spgemm(A: BSR, B: BSR, meta: _spgemm.BsrSpgemmMeta | None = None,
               skip_zero: bool = True) -> BSR:
    """C = A @ B as BSR (f32 blocks) with host-planned block structure."""
    if A.shape[1] != B.shape[0] or A.block_size != B.block_size:
        raise ValueError(f"incompatible operands {A.shape} x {B.shape}")
    meta = meta or _spgemm.bsr_spgemm_symbolic(A, B)
    blocks = _spgemm.bsr_spgemm_blocks(
        _with_zero_block(A.blocks), _with_zero_block(B.blocks),
        meta.a_slots, meta.b_slots, nc_pad=meta.nc_pad, u_max=meta.u_max,
        bs=A.block_size, skip_zero=skip_zero)
    per_row = meta.c_indptr[1:] - meta.c_indptr[:-1]
    dev = A.device
    return BSR(
        block_indptr=torch.from_numpy(meta.c_indptr).to(dev),
        block_indices=torch.from_numpy(meta.c_indices).to(dev),
        blocks=blocks,
        shape=(A.shape[0], B.shape[1]),
        block_size=A.block_size,
        max_row_blocks=int(per_row.max()) if per_row.size else 0,
    )


def bsr_spmm(A: BSR, x: torch.Tensor, meta: _spmm.BsrSpmmMeta | None = None,
             bn: int = 128) -> torch.Tensor:
    """y = A @ x (f32) with dense x ``[A.shape[1], nf]``."""
    if x.shape[0] != A.shape[1]:
        raise ValueError(f"incompatible {A.shape} @ {tuple(x.shape)}")
    meta = meta or _spmm.bsr_spmm_symbolic(A)
    nf = x.shape[1]
    bn_eff = min(bn, nf)
    if nf % bn_eff:
        raise ValueError(f"nf={nf} not divisible by bn={bn_eff}")
    return _spmm.bsr_spmm_blocks(_with_zero_block(A.blocks), x.contiguous(),
                                 meta.a_slots, meta.a_cols, mb=A.mb,
                                 u_max=meta.u_max, bs=A.block_size, bn=bn_eff)
