"""Public wrappers around the kernels: for the BSR kernels, host-side
symbolic planning (NumPy) and the zero-sentinel block appended; then the
kernel (on the card) or its plain version (on the CPU).

The port of the JAX package's ``kernels/ops.py``: ``bsr_spgemm``,
``bsr_spmm``, ``grouped_matmul`` (host-planned, padded: the reference's
API), and the wrappers the model's serving path calls: the attention
wrappers ``flash_prefill`` and ``decode_attention``, and
``grouped_matmul_ragged``, the MoE layer's sync-free grouped GEMM.

The four LM wrappers refuse autograd: their kernels launch through ctypes
and return tensors without autograd history, so a weight behind them would
silently get no gradient on the card (while the CPU's plain versions would
differentiate). Under grad mode they raise on any input that requires
grad, on every device; training runs ``models.transformer.forward``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bsr_spgemm as _spgemm
from repro_torch.kernels import bsr_spmm as _spmm
from repro_torch.kernels import chunked_attention as _attn
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.sparse.bsr import BSR


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name} takes no part in autograd (its kernel records no history); "
            "train through models.transformer.forward, or call it under torch.no_grad()")


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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes,
                   bt: int = 128, bn: int = 128, bk: int = 128):
    """Ragged grouped GEMM over *unsorted-by-tile* data already grouped by expert:
    x rows [sum(group_sizes), K] laid out group-contiguously.

    Returns (y [T_pad, N], padded_offsets) where rows [padded_offsets[g],
    padded_offsets[g] + group_sizes[g]) of y hold group g's outputs; the pad
    rows of y are zeros. The plan is made on the host (NumPy)."""
    _refuse_autograd("grouped_matmul", x, w)
    sizes = np.asarray(torch.as_tensor(group_sizes).cpu(), np.int64)
    offsets, tile_group, t_pad = _gmm.plan_groups(sizes, bt)
    if not tile_group.size:   # every group empty (the reference's kernel fails here)
        return x.new_zeros((t_pad, w.shape[2])), offsets
    dst_rows = np.concatenate([np.arange(n) + offsets[g] for g, n in enumerate(sizes)])
    xp = x.new_zeros((t_pad, x.shape[1]))
    xp[torch.from_numpy(dst_rows).to(x.device)] = x[: int(sizes.sum())]
    y = _gmm.grouped_matmul_padded(xp, w.contiguous(), torch.from_numpy(tile_group),
                                   bt=bt, bn=bn, bk=bk)
    return y, offsets


def grouped_matmul_ragged(x: torch.Tensor, w: torch.Tensor, seg_rows: torch.Tensor,
                          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Group g's rows ``[seg_rows[g], seg_rows[g + 1])`` of x times ``w[g]``,
    planned on the device (no host sync); rows from ``seg_rows[-1]`` on are
    not computed. ``[T, N]`` in ``out_dtype`` (default x's)."""
    _refuse_autograd("grouped_matmul_ragged", x, w)
    return _gmm.grouped_matmul_ragged(x, w, seg_rows, out_dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q ``[B, Hkv, G, D]`` over the cache k, v ``[B, S, Hkv, D]``, positions
    ``< lengths[b]`` visible; ``[B, Hkv, G, D]`` in q's dtype."""
    _refuse_autograd("decode_attention", q, k, v)
    return _attn.decode_attention(q, k, v, lengths)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int = 256,
                  bk: int = 512, window: int = 0) -> torch.Tensor:
    """Causal (plus ``window``) GQA attention, q ``[B, S, H, D]``, k, v
    ``[B, S, Hkv, D]``; ``bq``/``bk`` are the plain version's block sizes."""
    _refuse_autograd("flash_prefill", q, k, v)
    return _fp.flash_prefill(q, k, v, bq=bq, bk=bk, window=window)
