"""Dense-slab ranged SpGEMM: ``C[b,i] = sum_j A[b,i][:, r0_j:r0_j+span] @ B_slab[b,j] + C0[b,i]``.

The port of the JAX package's ``ranged_spgemm_stream`` (a Pallas kernel that
streamed one operand through a two-slot VMEM buffer). On the card this is
the CUDA kernel ``csrc/ranged_spgemm.cu``: full-float32 FMAs in 64x64 output
tiles, the chunk loop inside the block (chunk1) or one launch per chunk
(chunk2). On the CPU the wrapper runs :func:`ranged_spgemm_plain`.

Like the reference, entry-level sparsity is traded for dense tiles: the
staged B chunk is a dense ``[span, n]`` slab (its padding rows are zero), the
A strip a dense ``[strip_rows, k_pad]`` block with ``k_pad >= n_cols(A) +
span`` zero columns at the end, so the ranged column slice of the last chunk
stays in bounds.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import LaunchCounter, launch, require

LAUNCHES = LaunchCounter()
ORDERS = ("chunk1", "chunk2")


def _geometry(a_dense, b_slabs, c0, order: str) -> tuple:
    if order not in ORDERS:
        raise ValueError(f"unknown streaming order {order!r}")
    batch, n_ac, strip_rows, k_pad = a_dense.shape
    b_batch, n_b, span, n = b_slabs.shape
    if b_batch != batch:
        raise ValueError(f"b_slabs batch {b_batch} != a_dense batch {batch}")
    if tuple(c0.shape) != (batch, n_ac, strip_rows, n):
        raise ValueError(f"c0 shape {tuple(c0.shape)} != {(batch, n_ac, strip_rows, n)}")
    if k_pad < span:
        raise ValueError(f"k_pad={k_pad} < span={span}: A not column-padded")
    return batch, n_ac, strip_rows, k_pad, n_b, span, n


def ranged_spgemm_plain(a_dense: torch.Tensor, b_slabs: torch.Tensor,
                        c0: torch.Tensor, r0s, *, order: str) -> torch.Tensor:
    """Plain version: ``c0 + sum_j a[..., r0_j:r0_j+span] @ slab_j`` in chunk
    order. Both orders give every strip the same sequence of additions."""
    _, _, _, k_pad, n_b, span, _ = _geometry(a_dense, b_slabs, c0, order)
    out = c0
    for j, r0 in enumerate(_chunk_starts(r0s, n_b, span, k_pad)):
        out = out + torch.matmul(a_dense[..., r0:r0 + span], b_slabs[:, j, None])
    return out


def _chunk_starts(r0s, n_b: int, span: int, k_pad: int) -> list:
    """The chunk starts as host ints, each column slice inside ``k_pad``."""
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    if len(r0s) != n_b:
        raise ValueError(f"{len(r0s)} chunk starts for {n_b} slabs")
    for j, r0 in enumerate(r0s):
        if r0 < 0 or r0 + span > k_pad:
            raise ValueError(f"chunk {j}: columns [{r0}, {r0 + span}) exceed k_pad={k_pad}")
    return r0s


def ranged_spgemm_stream(a_dense: torch.Tensor, b_slabs: torch.Tensor,
                         c0: torch.Tensor, r0s, *, order: str) -> torch.Tensor:
    """Fused streaming multiply ``C[b, i] = sum_j A[b, i][:, r0_j:r0_j+span] @
    B_slab[b, j] + C_prev[b, i]``.

    Args:
      a_dense: f32[batch, n_ac, strip_rows, k_pad] — densified A strips, with
        ``k_pad >= n_cols(A) + span``.
      b_slabs: f32[batch, n_b, span, n] — densified staged B chunks.
      c0:      f32[batch, n_ac, strip_rows, n] — the fused ``C_prev``.
      r0s:     i32[n_b] — global start row of each B chunk.
      order:   "chunk1" (strips outer, B slabs streamed) or "chunk2"
               (chunks outer, A strips streamed).

    Returns f32[batch, n_ac, strip_rows, n]. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if a_dense.device.type == "cpu":
        return ranged_spgemm_plain(a_dense, b_slabs, c0, r0s, order=order)
    batch, n_ac, strip_rows, k_pad, n_b, span, n = _geometry(a_dense, b_slabs, c0, order)
    dev = a_dense.device
    r0s = torch.tensor(_chunk_starts(r0s, n_b, span, k_pad), dtype=torch.int32,
                       device=dev)
    for t, what in ((a_dense, "a_dense"), (b_slabs, "b_slabs"), (c0, "c0")):
        require(t, what, torch.float32, dev)
    out = torch.empty_like(c0)
    launch("ranged_spgemm", "ranged_spgemm_launch",
           [a_dense, b_slabs, c0, r0s, out],
           [batch, n_ac, strip_rows, k_pad, n_b, span, n, ORDERS.index(order) + 1])
    LAUNCHES.bump()
    return out
