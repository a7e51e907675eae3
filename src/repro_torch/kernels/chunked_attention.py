"""Length-masked GQA decode attention (one query token per sequence).

The port of the JAX package's ``kernels/chunked_attention.py``. On the card,
:func:`decode_attention` launches the CUDA kernel
``csrc/chunked_attention.cu``; on the CPU it runs
:func:`decode_attention_plain`. Both take q ``[B, Hkv, G, D]``, the cache
k, v ``[B, S, Hkv, D]`` and ``lengths`` int32 ``[B]`` and return
``[B, Hkv, G, D]`` in q's dtype: position p of sequence b is visible iff
p < lengths[b], softmax in f32 with the 1/sqrt(D) scale. A sequence of
length 0 gets zeros (the reference's kernel divides 0 by 0 there).

The reference's ``bs_kv`` chunk size (and its ``S % bs_kv == 0``) has no
counterpart: the kernel's chunk is its own constant and it stops at each
sequence's length.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import LaunchCounter, launch, require

LAUNCHES = LaunchCounter()
NEG_INF = -1e30
HEAD_DIMS = (64, 128)       # the kernel's instantiations: the ported configs' widths
MAX_OUTPUTS = 2048          # G * D: 256 threads, 8 outputs each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: the masked softmax over the whole cache in f32."""
    d = q.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / (d ** 0.5)
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    visible = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(visible[:, None, None, :], scores, NEG_INF)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(scores, dim=-1), v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the first ``lengths[b]`` cache positions. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    takes f32 or bf16, D in ``HEAD_DIMS``, G * D at most ``MAX_OUTPUTS``,
    contiguous operands and int32 lengths on the card."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [B, Hkv, G, D] and [B, S, Hkv, D]")
    b, hkv, g, d = q.shape
    if k.shape[0] != b or k.shape[2] != hkv or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({b},)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.dtype not in _DTYPES or d not in HEAD_DIMS or g * d > MAX_OUTPUTS:
        raise ValueError(f"the kernel takes f32/bf16, D in {HEAD_DIMS} and G * D <= "
                         f"{MAX_OUTPUTS}; got {q.dtype}, D={d}, G={g}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t, name, q.dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    require(lengths, "lengths", torch.int32, q.device)
    out = torch.empty_like(q)
    launch("chunked_attention", "decode_attention_launch", [q, k, v, lengths, out],
           [b, k.shape[1], hkv, g, d, _DTYPES[q.dtype]])
    LAUNCHES.bump()
    return out
