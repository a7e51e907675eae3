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

The kernel splits the cache axis across ``n_split`` blocks per (sequence,
KV head) and combines their partial softmax states in a second pass
(flash-decoding), also when ``n_split`` is 1. :func:`choose_split` picks ``n_split`` on the host from
the shapes and the card's SM count only, never from ``lengths`` (no host
sync); each block takes ``ceil(len / n_split)`` positions of its own
sequence, rounded up to a ``BKV`` chunk.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import LaunchCounter, launch, require

LAUNCHES = LaunchCounter()
NEG_INF = -1e30
HEAD_DIMS = (64, 128)       # the kernel's instantiations: the ported configs' widths
MAX_OUTPUTS = 2048          # G * D: at most 128 (row tile, part of D) items, one a thread
BKV = 64                    # cache positions of one chunk of the kernel
MAX_SPLIT = 32              # splits of one sequence at most: the combine reads every split
BLOCKS_PER_SM = 2           # resident split-kernel blocks an SM (bf16, G >= 2: 213 registers)
KERNELS_PER_CALL = 2        # CUDA kernels one wrapper call launches: split, then combine
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def choose_split(b: int, hkv: int, s: int, n_sm: int) -> int:
    """Blocks per (sequence, KV head): as many as fit ``BLOCKS_PER_SM``
    blocks an SM over the ``b * hkv`` pairs, so that every block runs in
    one wave (a second wave of a few blocks costs more than the splits
    gain); at least 1, at most ``MAX_SPLIT`` and at most one a chunk of the
    cache. Shapes only: the lengths are not read, nor the dtype.

    The rule is sized for the bf16 serve kernels (registers allow two
    blocks an SM). The f32 D = 128 instantiation's 128 KB ring of shared
    memory fits one block an SM, so its blocks take two waves where this
    fills two."""
    fit = BLOCKS_PER_SM * n_sm // max(b * hkv, 1)
    return max(1, min(fit, MAX_SPLIT, -(-s // BKV)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_split(b: int, hkv: int, s: int, device: torch.device) -> int:
    """:func:`choose_split` with the SM count of ``device`` (cached)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return choose_split(b, hkv, s, _sm_count(index))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, cast_free: bool = False) -> torch.Tensor:
    """Plain version: the masked softmax over the whole cache in f32;
    ``cast_free`` rounds the probabilities to V's dtype before the PV
    product (the reference's lever; its bf16 operands with f32 results are
    the upcast operands' f32 products)."""
    d = q.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / (d ** 0.5)
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    visible = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(visible[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if cast_free:
        p = p.to(v.dtype).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, cast_free: bool = False) -> torch.Tensor:
    """Decode attention over the first ``lengths[b]`` cache positions. CPU
    tensors take the plain version (with ``cast_free``); CUDA tensors
    launch the kernel, which takes f32 or bf16, D in ``HEAD_DIMS``, G * D
    at most ``MAX_OUTPUTS``, contiguous operands and int32 lengths on the
    card. The kernel computes the same with ``cast_free`` on or off: it
    widens each bf16 cache row to f32 and takes every product and sum in
    f32 on FMAs, P unrounded."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [B, Hkv, G, D] and [B, S, Hkv, D]")
    b, hkv, g, d = q.shape
    if k.shape[0] != b or k.shape[2] != hkv or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({b},)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, cast_free=cast_free)
    if q.dtype not in _DTYPES or d not in HEAD_DIMS or g * d > MAX_OUTPUTS:
        raise ValueError(f"the kernel takes f32/bf16, D in {HEAD_DIMS} and G * D <= "
                         f"{MAX_OUTPUTS}; got {q.dtype}, D={d}, G={g}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t, name, q.dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    require(lengths, "lengths", torch.int32, q.device)
    s = k.shape[1]
    n_split = device_split(b, hkv, s, q.device)
    out = torch.empty_like(q)
    # the split partials (acc, then m and l), f32, written before they are read
    part = torch.empty(b * hkv * n_split * g * (d + 2), dtype=torch.float32, device=q.device)
    launch("chunked_attention", "decode_attention_launch", [q, k, v, lengths, out, part],
           [b, s, hkv, g, d, _DTYPES[q.dtype], n_split])
    LAUNCHES.bump()
    return out
