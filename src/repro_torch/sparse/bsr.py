"""Padded BSR (block CSR) container on torch tensors.

Sparsity at *block* granularity: each nonzero block is a dense ``bs x bs``
tile. Layout mirrors CSR: ``block_indptr`` (exact, per block-row),
``block_indices`` / ``blocks`` padded in the tail. Padding blocks are
all-zero with block-column 0 — the zero-sentinel contract the BSR kernel's
slot tables rely on (:func:`bsr_blocks_with_sentinel`).

The conversions from dense and from CSR run on the host in NumPy, as the
JAX package's do; the result lands on ``device`` (``None`` = the CUDA card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.csr import CSR, _np, resolve_device


@dataclasses.dataclass(frozen=True)
class BSR:
    """Padded block-sparse-row matrix with square ``block_size`` blocks."""

    block_indptr: torch.Tensor   # int32[mb + 1]
    block_indices: torch.Tensor  # int32[nbl_pad]
    blocks: torch.Tensor         # dtype[nbl_pad, bs, bs]
    shape: tuple                 # (n_rows, n_cols) in *elements*
    block_size: int
    max_row_blocks: int          # upper bound on blocks in any block-row

    @property
    def mb(self) -> int:
        """Number of block rows."""
        return self.shape[0] // self.block_size

    @property
    def nb(self) -> int:
        """Number of block columns."""
        return self.shape[1] // self.block_size

    @property
    def nbl_pad(self) -> int:
        return self.block_indices.shape[0]

    def n_blocks(self) -> int:
        return int(self.block_indptr[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.block_indptr, self.block_indices, self.blocks))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"BSR(shape={self.shape}, bs={self.block_size}, "
                f"nbl_pad={self.nbl_pad}, dtype={self.dtype}, device={self.device})")


def _host(dense):
    """(float NumPy array, torch dtype of the blocks) of a dense operand."""
    if isinstance(dense, torch.Tensor):
        return dense.detach().float().cpu().numpy(), dense.dtype
    dense = np.asarray(dense)
    dtype = torch.float16 if dense.dtype == np.float16 else torch.float32
    return dense, dtype


def _assemble(indptr, indices, blocks, shape, bs, dtype, device) -> BSR:
    row_blocks = indptr[1:] - indptr[:-1]
    return BSR(
        block_indptr=torch.from_numpy(indptr.astype(np.int32)).to(device),
        block_indices=torch.from_numpy(indices.astype(np.int32)).to(device),
        blocks=torch.from_numpy(np.ascontiguousarray(blocks)).to(device=device,
                                                                 dtype=dtype),
        shape=(int(shape[0]), int(shape[1])),
        block_size=bs,
        max_row_blocks=int(row_blocks.max()) if row_blocks.size else 0,
    )


def bsr_from_dense(dense, block_size: int, pad_to: int | None = None,
                   keep_zero_blocks: bool = False, device=None) -> BSR:
    """Host-side dense -> BSR. A block is kept iff it has any nonzero (or all, if
    ``keep_zero_blocks``). A tensor keeps its dtype (bf16 included)."""
    device = resolve_device(device)
    dense, dtype = _host(dense)
    n_rows, n_cols = dense.shape
    bs = int(block_size)
    if n_rows % bs or n_cols % bs:
        raise ValueError(f"shape {dense.shape} not divisible by block_size {bs}")
    mb, nb = n_rows // bs, n_cols // bs
    tiles = dense.reshape(mb, bs, nb, bs).transpose(0, 2, 1, 3)  # [mb, nb, bs, bs]
    mask = np.ones((mb, nb), bool) if keep_zero_blocks else (tiles != 0).any(axis=(2, 3))
    bi, bj = np.nonzero(mask)
    order = np.lexsort((bj, bi))
    bi, bj = bi[order], bj[order]
    nbl = bi.size
    cap = int(pad_to) if pad_to is not None else max(nbl, 1)
    if cap < nbl:
        raise ValueError(f"pad_to={cap} < n_blocks={nbl}")
    indptr = np.zeros(mb + 1, np.int64)
    np.add.at(indptr, bi + 1, 1)
    indptr = np.cumsum(indptr)
    blocks = np.zeros((cap, bs, bs), dense.dtype)
    blocks[:nbl] = tiles[bi, bj]
    indices = np.zeros(cap, np.int32)
    indices[:nbl] = bj
    return _assemble(indptr, indices, blocks, (n_rows, n_cols), bs, dtype, device)


def bsr_blocks_with_sentinel(m: BSR) -> torch.Tensor:
    """Blocks with the zero-sentinel block appended at index ``nbl_pad``.

    The BSR SpGEMM kernel's padding slots all point at ``nbl_pad``
    (``kernels.bsr_spgemm.bsr_spgemm_symbolic``), so slot ``nbl_pad`` being
    all-zero is what makes padding steps MAC nothing. This is the one place
    the sentinel is appended, and it *verifies* the container contract on
    the way: the padding tail (``blocks[n_blocks:]``) must be all-zero, or a
    mis-aimed slot would corrupt C silently instead of loudly.
    """
    nbl = m.n_blocks()
    if bool((m.blocks[nbl:] != 0).any()):
        raise ValueError(
            f"BSR padding tail (blocks {nbl}..{m.blocks.shape[0]}) contains "
            "nonzeros; the kernel's zero-sentinel contract requires padding "
            "blocks to be all-zero"
        )
    zero = m.blocks.new_zeros((1,) + tuple(m.blocks.shape[1:]))
    return torch.cat([m.blocks, zero]).contiguous()


def bsr_to_dense(m: BSR) -> torch.Tensor:
    """Densify by scatter-add of blocks (padding blocks are zero)."""
    bs, mb, nb = m.block_size, m.mb, m.nb
    entry = torch.arange(m.nbl_pad, dtype=torch.int32, device=m.device)
    brow = (torch.searchsorted(m.block_indptr, entry, right=True) - 1).clamp(0, max(mb - 1, 0))
    tiles = torch.zeros((mb, nb, bs, bs), dtype=m.dtype, device=m.device)
    if mb and nb:
        tiles.index_put_((brow, m.block_indices.long()), m.blocks, accumulate=True)
    return tiles.permute(0, 2, 1, 3).reshape(m.shape)


def bsr_from_csr(m: CSR, block_size: int, pad_to: int | None = None) -> BSR:
    """Host-side CSR -> BSR (pads the element shape up to a block multiple).
    A block is kept iff it holds a stored entry; the result lands on ``m``'s
    device."""
    indptr = _np(m.indptr)
    indices = _np(m.indices)
    data = _np(m.data)
    nnz = int(indptr[-1])
    bs = int(block_size)
    n_rows = -(-m.shape[0] // bs) * bs
    n_cols = -(-m.shape[1] // bs) * bs
    rows = np.repeat(np.arange(m.shape[0]), indptr[1:] - indptr[:-1])
    cols = indices[:nnz].astype(np.int64)
    vals = data[:nnz]
    mb, nb = n_rows // bs, n_cols // bs
    bi, bj = rows // bs, cols // bs
    bkey = bi * nb + bj
    uniq = np.unique(bkey)
    nbl = uniq.size
    cap = int(pad_to) if pad_to is not None else max(nbl, 1)
    if cap < nbl:
        raise ValueError(f"pad_to={cap} < n_blocks={nbl}")
    blocks = np.zeros((cap, bs, bs), vals.dtype)
    # dense index of each entry's block among the unique sorted blocks
    entry_block = np.searchsorted(uniq, bkey)
    np.add.at(blocks, (entry_block, rows % bs, cols % bs), vals)
    ubi, ubj = uniq // nb, uniq % nb
    indptr_b = np.zeros(mb + 1, np.int64)
    np.add.at(indptr_b, ubi + 1, 1)
    indptr_b = np.cumsum(indptr_b)
    indices_b = np.zeros(cap, np.int32)
    indices_b[:nbl] = ubj
    return _assemble(indptr_b, indices_b, blocks, (n_rows, n_cols), bs, m.dtype,
                     m.device)
