"""Causal GQA flash attention for prefill.

The port of the JAX package's ``kernels/flash_prefill.py``. On the card,
:func:`flash_prefill` launches a CUDA kernel of ``csrc/flash_prefill.cu``
by one of two routes (:func:`choose_route`): ``"tc"``, bf16 on the tensor
cores, or ``"fma"``, f32 on f32 FMAs; on the CPU it runs
:func:`flash_prefill_plain`, the same chunked online softmax in plain
PyTorch. Both take q ``[B, S, H, D]`` and k, v ``[B, S, Hkv, D]`` and
return ``[B, S, H, D]`` in q's dtype: 1/sqrt(D) scale, causal (plus an
optional sliding ``window``), the finite ``NEG_INF`` mask, f32 statistics and
sums, and ``acc / max(l, 1e-30)``. GQA is folded: query head ``h`` reads KV
head ``h // (H / Hkv)``.

The reference's Pallas wrapper required ``S % bq == 0``; the kernel masks
its own ragged edge, and ``bq``/``bk`` are only the plain version's block
sizes (it pads ragged tails, as the JAX package's pure ``flash_attention``
does).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import LaunchCounter, launch, require

LAUNCHES = LaunchCounter()                    # every launch of the kernel
ROUTES = ("tc", "fma")
ROUTE_LAUNCHES = {r: LaunchCounter() for r in ROUTES}   # the launches of each route
NEG_INF = ref.NEG_INF
HEAD_DIMS = (64, 128)       # the kernel's instantiations: the ported configs' widths
MAX_GROUP = 64              # query heads per KV head the kernel folds into a tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def choose_route(dtype: torch.dtype) -> str:
    """The kernel a card call takes: bf16 on the tensor cores (``"tc"``:
    bf16 products, f32 sums), f32 on f32 FMAs (``"fma"``), since the tensor
    cores have no f32-exact mode."""
    return "tc" if dtype == torch.bfloat16 else "fma"


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, bq: int = 256, bk: int = 512,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Plain version: a loop over ``bq``-row query chunks, each streaming the
    ``bk``-key chunks it can see under an f32 online softmax
    (``ref.chunked_attention``, the JAX package's pure ``flash_attention``).
    ``q_offset`` is the global position of q[0] relative to k[0] (prefill:
    0); ``causal`` off attends to every key (within the window)."""
    return ref.chunked_attention(q, k, v, causal=causal, window=window, q_chunk=bq,
                                 kv_chunk=bk, q_offset=q_offset)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  bq: int = 256, bk: int = 512, window: int = 0) -> torch.Tensor:
    """Causal (plus ``window``) GQA attention of a prompt batch. CPU tensors
    take the plain version (with ``bq``/``bk``); CUDA tensors launch the
    kernel, which takes f32 or bf16, D in ``HEAD_DIMS``, H / Hkv at most
    ``MAX_GROUP`` and contiguous operands, on :func:`choose_route`'s route."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [B, S, H, D] and [B, S, Hkv, D]")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, bq=bq, bk=bk)
    if q.dtype not in _DTYPES or d not in HEAD_DIMS or h // hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes f32/bf16, D in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head; got {q.dtype}, D={d}, "
                         f"{h // hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t, name, q.dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    launch("flash_prefill", "flash_prefill_launch", [q, k, v, out],
           [b, s, h, hkv, d, window, _DTYPES[q.dtype]])
    LAUNCHES.bump()
    ROUTE_LAUNCHES[choose_route(q.dtype)].bump()
    return out
