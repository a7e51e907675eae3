"""Dense-slab ranged SpGEMM: ``C[b,i] = sum_j A[b,i][:, r0_j:r0_j+span] @ B_slab[b,j] + C0[b,i]``.

The port of the JAX package's ``ranged_spgemm_stream`` (a Pallas kernel that
streamed one operand through a two-slot VMEM buffer). On the card this is
the CUDA kernel ``csrc/ranged_spgemm.cu``: full-float32 FMAs in 128x128
output tiles with 8x8 register tiles, the span staged through two
shared-memory buffers, the chunk loop inside the block (chunk1) or one
launch per chunk (chunk2). :func:`choose_path` picks its float4 / cp.async
path (``"vec"``) where alignment allows and its masked scalar path
otherwise. On the CPU the wrapper runs :func:`ranged_spgemm_plain`.

Like the reference, entry-level sparsity is traded for dense tiles: the
staged B chunk is a dense ``[span, n]`` slab (its padding rows are zero), the
A strip a dense ``[strip_rows, k_pad]`` block with ``k_pad >= n_cols(A) +
span`` zero columns at the end, so the ranged column slice of the last chunk
stays in bounds.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import copy_events
from repro_torch.kernels._build import (
    LaunchCounter, alloc_like, launch, pointer, require,
)
from repro_torch.sparse.csr import kernel_device, reads_host

LAUNCHES = LaunchCounter()
ORDERS = ("chunk1", "chunk2")
PATH_LAUNCHES = {"vec": LaunchCounter(), "scalar": LaunchCounter()}   # by load path
IN_PLACE = LaunchCounter()   # launches that read an operand in pinned host memory


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
    copy_events.record_dense_stream(a_dense, b_slabs, c0, order)
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


def choose_path(a_dense: torch.Tensor, b_slabs: torch.Tensor, c0: torch.Tensor,
                r0s) -> str:
    """The kernel's load path: ``"vec"`` (float4 loads of A and C, 16-byte
    cp.async of B) when the three operands start on 16 bytes and ``k_pad``,
    ``span``, ``n`` and every chunk start are multiples of 4 floats, so that
    every row slice starts on 16 bytes; else ``"scalar"`` (masked 4-byte
    loads). The output, a fresh allocation, is always aligned."""
    k_pad, (span, n) = a_dense.shape[-1], b_slabs.shape[-2:]
    aligned = all(t.data_ptr() % 16 == 0 for t in (a_dense, b_slabs, c0))
    multiples = all(int(x) % 4 == 0 for x in (k_pad, span, n, *torch.as_tensor(r0s).tolist()))
    return "vec" if aligned and multiples else "scalar"


def ranged_spgemm_stream(a_dense: torch.Tensor, b_slabs: torch.Tensor,
                         c0: torch.Tensor, r0s, *, order: str, device=None) -> torch.Tensor:
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
      device:  where it runs (:func:`kernel_device`): ``None`` takes
               ``a_dense``'s device (pinned host operands raise), "cpu" the
               plain version, the card launches the kernel, which reads an
               operand in pinned host memory in place.

    Returns f32[batch, n_ac, strip_rows, n], in ``c0``'s space: on the card,
    or in pinned host memory (written by the kernel in place, complete on
    return) when ``c0`` is there.
    """
    dev = kernel_device("ranged_spgemm_stream", device, a_dense, b_slabs, c0)
    if dev is None:
        return ranged_spgemm_plain(a_dense, b_slabs, c0, r0s, order=order)
    batch, n_ac, strip_rows, k_pad, n_b, span, n = _geometry(a_dense, b_slabs, c0, order)
    starts = _chunk_starts(r0s, n_b, span, k_pad)
    for t, what in ((a_dense, "a_dense"), (b_slabs, "b_slabs"), (c0, "c0")):
        require(t, what, torch.float32, dev, in_place=True)
    path = choose_path(a_dense, b_slabs, c0, starts)
    r0s = torch.tensor(starts, dtype=torch.int32, device=dev)
    out = alloc_like(c0)
    launch("ranged_spgemm", "ranged_spgemm_launch",
           [pointer(a_dense), pointer(b_slabs), pointer(c0), r0s, pointer(out)],
           [batch, n_ac, strip_rows, k_pad, n_b, span, n, ORDERS.index(order) + 1,
            int(path == "vec")])
    LAUNCHES.bump()
    PATH_LAUNCHES[path].bump()
    if reads_host(a_dense, b_slabs, c0):
        IN_PLACE.bump()
        # the host may read a pinned output, or free a pinned input, as soon
        # as the call returns
        torch.cuda.current_stream(dev).synchronize()
    return out
