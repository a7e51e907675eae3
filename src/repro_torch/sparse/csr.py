"""Padded CSR container on torch tensors, conversions and geometry envelopes.

Conventions (the same as the JAX package's, so byte counts and plans match):
  * ``indptr``  : int32[n_rows + 1]  -- standard CSR row pointers. ``indptr[-1]`` is the
                  true nnz; entries past it in ``indices``/``data`` are padding.
  * ``indices`` : int32[nnz_pad]     -- column index per entry; padding entries are 0.
  * ``data``    : float32[nnz_pad]   -- value per entry; padding entries are 0.0.
  * rows are contiguous (no per-row padding); all padding lives in the tail.
  * ``shape`` and ``max_row_nnz`` are plain Python metadata.

Index arrays stay int32 as in the reference; code casts to int64 locally
where a torch op demands it (``gather``, ``index_select``, ``scatter_*``).

Every constructor takes ``device``: ``None`` means the CUDA card and raises
when there is none (:func:`resolve_device`); it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} selects the CUDA card, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return resolved


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(np_dtype) -> torch.dtype:
    """The value dtype a host array becomes (float64 narrows to float32, as
    the reference's arrays do without 64-bit mode)."""
    return torch.float16 if np.dtype(np_dtype) == np.float16 else torch.float32


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the envelope's dtype field)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class CSR:
    """Padded compressed-sparse-row matrix on one device."""

    indptr: torch.Tensor   # int32[n_rows + 1]
    indices: torch.Tensor  # int32[nnz_pad]
    data: torch.Tensor     # float32[nnz_pad]
    shape: tuple           # (n_rows, n_cols)
    max_row_nnz: int       # upper bound on nnz of any row

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_pad(self) -> int:
        """Padded capacity."""
        return self.indices.shape[-1]

    def nnz(self) -> int:
        """True nnz (reads the last row pointer)."""
        return int(self.indptr[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def nbytes(self) -> int:
        """Padded byte footprint — what a memory level must actually hold."""
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.indices, self.data))

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def astype(self, dtype) -> "CSR":
        return CSR(self.indptr, self.indices, self.data.to(dtype), self.shape,
                   self.max_row_nnz)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"CSR(shape={self.shape}, nnz_pad={self.nnz_pad}, "
            f"max_row_nnz={self.max_row_nnz}, dtype={self.dtype}, "
            f"device={self.device})"
        )


def _max_row(indptr: torch.Tensor) -> int:
    if indptr.numel() <= 1:
        return 0
    return int((indptr[1:] - indptr[:-1]).max())


def _csr_from_tensors(indptr: torch.Tensor, indices: torch.Tensor,
                      data: torch.Tensor, shape: tuple, nnz: int,
                      pad_to: int | None) -> CSR:
    """Pad the ``nnz`` leading entries of device tensors to ``pad_to``."""
    cap = int(pad_to) if pad_to is not None else nnz
    if cap < nnz:
        raise ValueError(f"pad_to={cap} < nnz={nnz}")
    cap = max(cap, 1)
    indices = indices[:nnz].to(torch.int32)
    data = data[:nnz]
    if cap > nnz:
        indices = torch.cat([indices, indices.new_zeros(cap - nnz)])
        data = torch.cat([data, data.new_zeros(cap - nnz)])
    indptr = indptr.to(torch.int32)
    return CSR(indptr.contiguous(), indices.contiguous(), data.contiguous(),
               (int(shape[0]), int(shape[1])), _max_row(indptr))


def csr_from_scipy_like(indptr, indices, data, shape, pad_to: int | None = None,
                        dtype=torch.float32, device=None) -> CSR:
    """Build a CSR from host arrays (NumPy), padding the tail to ``pad_to``."""
    device = resolve_device(device)
    indptr = np.asarray(_np(indptr), dtype=np.int32)
    indices = np.asarray(_np(indices), dtype=np.int32)
    data = _np(data)
    nnz = int(indptr[-1])
    cap = int(pad_to) if pad_to is not None else nnz
    if cap < nnz:
        raise ValueError(f"pad_to={cap} < nnz={nnz}")
    cap = max(cap, 1)   # keep one slot: downstream gathers clip into it
    pad = cap - nnz
    if pad:
        indices = np.concatenate([indices[:nnz], np.zeros(pad, np.int32)])
        data = np.concatenate([data[:nnz], np.zeros(pad, data.dtype)])
    else:
        indices, data = indices[:nnz], data[:nnz]
    row_len = indptr[1:] - indptr[:-1]
    max_row = int(row_len.max()) if len(row_len) else 0
    np_dtype = _NP_DTYPES[dtype]
    return CSR(
        indptr=torch.from_numpy(np.ascontiguousarray(indptr)).to(device),
        indices=torch.from_numpy(np.ascontiguousarray(indices)).to(device),
        data=torch.from_numpy(np.ascontiguousarray(data.astype(np_dtype))).to(device),
        shape=(int(shape[0]), int(shape[1])),
        max_row_nnz=max_row,
    )


def csr_from_coo(rows, cols, vals, shape, pad_to: int | None = None,
                 dtype=torch.float32, sum_duplicates: bool = True,
                 device=None) -> CSR:
    """Host-side COO -> CSR (sorts by (row, col), optionally coalescing duplicates)."""
    rows = np.asarray(_np(rows), dtype=np.int64)
    cols = np.asarray(_np(cols), dtype=np.int64)
    vals = np.asarray(_np(vals), dtype=np.float64)
    n_rows, n_cols = int(shape[0]), int(shape[1])
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    if sum_duplicates and key.size:
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros(uniq.size, np.float64)
        np.add.at(acc, inv, vals)
        key, vals = uniq, acc
    out_rows = key // n_cols
    out_cols = key % n_cols
    indptr = np.zeros(n_rows + 1, np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    indptr = np.cumsum(indptr)
    return csr_from_scipy_like(indptr, out_cols, vals, (n_rows, n_cols), pad_to,
                               dtype, device)


def csr_from_dense(dense, pad_to: int | None = None, device=None) -> CSR:
    """Dense -> CSR. A NumPy array converts on the host, a tensor on
    ``device`` (row-major ``nonzero`` order, the same entries either way)."""
    device = resolve_device(device)
    if not isinstance(dense, torch.Tensor):
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return csr_from_coo(rows, cols, dense[rows, cols], dense.shape, pad_to,
                            dtype=_torch_dtype(dense.dtype),
                            sum_duplicates=False, device=device)
    dense = dense.to(device)
    n_rows, n_cols = dense.shape
    nz = torch.nonzero(dense)
    rows, cols = nz[:, 0], nz[:, 1]
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return _csr_from_tensors(indptr, cols, dense[rows, cols], (n_rows, n_cols),
                             int(rows.numel()), pad_to)


def csr_row_of_entry(m: CSR) -> torch.Tensor:
    """Row id (int64) of every padded entry (padding maps to the last row;
    its data is 0)."""
    entry = torch.arange(m.nnz_pad, dtype=torch.int32, device=m.device)
    row = torch.searchsorted(m.indptr, entry, right=True) - 1
    return row.clamp(0, max(m.n_rows - 1, 0))


def csr_to_dense(m: CSR) -> torch.Tensor:
    """Densify by scatter-add (padding entries carry data == 0, so they only
    ever add zero into column 0)."""
    dense = torch.zeros(m.shape, dtype=m.dtype, device=m.device)
    if m.n_rows == 0:
        return dense
    dense.index_put_((csr_row_of_entry(m), m.indices.long()), m.data,
                     accumulate=True)
    return dense


def csr_select_rows_host(m: CSR, r0: int, r1: int, pad_to: int | None = None) -> CSR:
    """Row slice m[r0:r1, :] as a new CSR on ``m``'s device."""
    s, e = (int(v) for v in m.indptr[[r0, r1]].tolist())
    new_ptr = m.indptr[r0 : r1 + 1] - s
    return _csr_from_tensors(new_ptr, m.indices[s:e], m.data[s:e],
                             (r1 - r0, m.shape[1]), e - s, pad_to)


def _union_bsr_caps(a: tuple, b: tuple) -> tuple:
    """Elementwise max of two block-cap tuples. Mixing a block-capped
    envelope with an uncapped one (or two different block sizes) is a caller
    bug, so both fail loudly."""
    if not a and not b:
        return ()
    if not a or not b:
        raise ValueError(
            "cannot union a block-capped envelope with an uncapped one; "
            "build every instance envelope with the same block_size")
    if a[0] != b[0]:
        raise ValueError(f"block_size mismatch in envelope union: {a[0]} vs {b[0]}")
    return (a[0], *(max(x, y) for x, y in zip(a[1:], b[1:])))


@dataclasses.dataclass(frozen=True)
class GeometryEnvelope:
    """Padded geometry that a chunked-SpGEMM launch is staged for.

    Every field is host-static and the envelope is hashable. ``union`` over
    per-instance envelopes yields the smallest geometry that fits them all.
    ``chunk_rows``/``strip_rows`` derive from the plan's row partitions; the
    nnz caps and ``max_row_nnz`` bounds are per-instance quantities.

    The output-cap fields (``c_nnz_cap``, ``c_max_row_nnz``) come from the
    symbolic phase (``repro_torch.core.symbolic``); ``c_pad`` is the per-strip
    capacity of the CSR accumulators. A value of 0 means "not computed"; the
    algebra absorbs 0 under union and preserves it under quantization.
    ``bsr_caps`` holds the block caps of ``symbolic.bsr_plan_caps`` when the
    envelope was built with a ``block_size``; an uncapped envelope prices the
    ``bsr`` backend out of ``auto``.
    """

    a_shape: tuple      # (m, k) of every A instance
    b_shape: tuple      # (k, n) of every B instance
    a_nnz_cap: int      # padded nnz capacity of the whole-A operand (KNL)
    a_max_row_nnz: int  # bound on any A row
    b_max_row_nnz: int  # bound on any B row (sizes the expansion buffer)
    chunk_rows: int     # rows every staged B chunk is padded to
    chunk_nnz_cap: int  # nnz capacity every staged B chunk is padded to
    strip_rows: int     # rows every staged A/C strip is padded to
    strip_nnz_cap: int  # nnz capacity every staged A strip is padded to
    c_pad: int          # output capacity (>= exact symbolic nnz of any C strip)
    dtype: str          # value dtype name ("float32", ...)
    c_nnz_cap: int = 0      # whole-C structure capacity (symbolic; 0 = unset)
    c_max_row_nnz: int = 0  # densest C row bound (symbolic; 0 = unset)
    bsr_caps: tuple = ()    # (block_size, nbl_a, nbl_b, nc, u); () = not computed

    def _check_compatible(self, other: "GeometryEnvelope") -> None:
        if (self.a_shape != other.a_shape or self.b_shape != other.b_shape
                or self.dtype != other.dtype):
            raise ValueError(
                "incompatible envelopes: "
                f"{self.a_shape}x{self.b_shape}/{self.dtype} vs "
                f"{other.a_shape}x{other.b_shape}/{other.dtype}"
            )

    def union(self, other: "GeometryEnvelope") -> "GeometryEnvelope":
        """Smallest envelope covering both (same shapes/dtype required)."""
        self._check_compatible(other)
        return GeometryEnvelope(
            a_shape=self.a_shape, b_shape=self.b_shape,
            a_nnz_cap=max(self.a_nnz_cap, other.a_nnz_cap),
            a_max_row_nnz=max(self.a_max_row_nnz, other.a_max_row_nnz),
            b_max_row_nnz=max(self.b_max_row_nnz, other.b_max_row_nnz),
            chunk_rows=max(self.chunk_rows, other.chunk_rows),
            chunk_nnz_cap=max(self.chunk_nnz_cap, other.chunk_nnz_cap),
            strip_rows=max(self.strip_rows, other.strip_rows),
            strip_nnz_cap=max(self.strip_nnz_cap, other.strip_nnz_cap),
            c_pad=max(self.c_pad, other.c_pad),
            dtype=self.dtype,
            c_nnz_cap=max(self.c_nnz_cap, other.c_nnz_cap),
            c_max_row_nnz=max(self.c_max_row_nnz, other.c_max_row_nnz),
            bsr_caps=_union_bsr_caps(self.bsr_caps, other.bsr_caps),
        )

    def dominates(self, other: "GeometryEnvelope") -> bool:
        """True when instances fitting ``other`` also fit this envelope."""
        try:
            self._check_compatible(other)
        except ValueError:
            return False
        return (self.a_nnz_cap >= other.a_nnz_cap
                and self.a_max_row_nnz >= other.a_max_row_nnz
                and self.b_max_row_nnz >= other.b_max_row_nnz
                and self.chunk_rows >= other.chunk_rows
                and self.chunk_nnz_cap >= other.chunk_nnz_cap
                and self.strip_rows >= other.strip_rows
                and self.strip_nnz_cap >= other.strip_nnz_cap
                and self.c_pad >= other.c_pad
                and self.c_nnz_cap >= other.c_nnz_cap
                and self.c_max_row_nnz >= other.c_max_row_nnz
                and self._dominates_bsr_caps(other))

    def _dominates_bsr_caps(self, other: "GeometryEnvelope") -> bool:
        if not other.bsr_caps:
            return True
        if not self.bsr_caps or self.bsr_caps[0] != other.bsr_caps[0]:
            return False
        return all(s >= o for s, o in zip(self.bsr_caps[1:], other.bsr_caps[1:]))

    def quantized(self, quantum: int = 32) -> "GeometryEnvelope":
        """Round the nnz caps up to ``quantum`` multiples and the row-nnz
        bounds up to powers of two, collapsing near-identical geometries."""

        def up(v: int) -> int:
            return max(quantum, -(-int(v) // quantum) * quantum)

        def up_pow2(v: int) -> int:
            return 1 << max(int(v) - 1, 0).bit_length() if v > 1 else max(v, 1)

        return GeometryEnvelope(
            a_shape=self.a_shape, b_shape=self.b_shape,
            a_nnz_cap=up(self.a_nnz_cap),
            a_max_row_nnz=up_pow2(self.a_max_row_nnz),
            b_max_row_nnz=up_pow2(self.b_max_row_nnz),
            chunk_rows=self.chunk_rows,
            chunk_nnz_cap=up(self.chunk_nnz_cap),
            strip_rows=self.strip_rows,
            strip_nnz_cap=up(self.strip_nnz_cap),
            c_pad=up(self.c_pad),
            dtype=self.dtype,
            c_nnz_cap=up(self.c_nnz_cap) if self.c_nnz_cap else 0,
            c_max_row_nnz=(up_pow2(self.c_max_row_nnz)
                           if self.c_max_row_nnz else 0),
            bsr_caps=self.bsr_caps,
        )

    def staged_nbytes(self) -> int:
        """Bytes one instance's staged buffers occupy when padded to this
        envelope: the whole-A operand, one A strip, one B chunk, and the C
        output capacity, each as (indices + data) entries plus an int32
        indptr."""
        itemsize = int(np.dtype(self.dtype).itemsize)
        entry = 4 + itemsize
        return int(
            self.a_nnz_cap * entry
            + self.strip_nnz_cap * entry + (self.strip_rows + 1) * 4
            + self.chunk_nnz_cap * entry + (self.chunk_rows + 1) * 4
            + self.c_pad * entry
        )

    @classmethod
    def batch(cls, envelopes) -> "GeometryEnvelope":
        """Union over per-instance envelopes (the batch's shared geometry)."""
        envelopes = list(envelopes)
        if not envelopes:
            raise ValueError("GeometryEnvelope.batch needs at least one envelope")
        out = envelopes[0]
        for env in envelopes[1:]:
            out = out.union(env)
        return out


def csr_pad_to(m: CSR, nnz_cap: int | None = None, rows: int | None = None,
               max_row_nnz: int | None = None) -> CSR:
    """Repad a CSR to a larger geometry: grow the entry tail to ``nnz_cap``,
    append empty rows up to ``rows``, and/or raise the ``max_row_nnz`` bound.
    Growing only: an undersized target fails loudly."""
    nnz_cap = m.nnz_pad if nnz_cap is None else int(nnz_cap)
    rows = m.n_rows if rows is None else int(rows)
    mrn = m.max_row_nnz if max_row_nnz is None else int(max_row_nnz)
    if nnz_cap < m.nnz_pad or rows < m.n_rows or mrn < m.max_row_nnz:
        raise ValueError(
            f"csr_pad_to only grows: nnz_cap={nnz_cap} rows={rows} "
            f"max_row_nnz={mrn} vs nnz_pad={m.nnz_pad} n_rows={m.n_rows} "
            f"max_row_nnz={m.max_row_nnz}"
        )
    indptr, indices, data = m.indptr, m.indices, m.data
    if rows > m.n_rows:
        indptr = torch.cat([indptr, indptr[-1:].expand(rows - m.n_rows)])
    if nnz_cap > m.nnz_pad:
        indices = torch.cat([indices, indices.new_zeros(nnz_cap - m.nnz_pad)])
        data = torch.cat([data, data.new_zeros(nnz_cap - m.nnz_pad)])
    return CSR(indptr, indices, data, (rows, m.shape[1]), mrn)


def csr_stack(mats) -> CSR:
    """Stack uniformly-padded CSRs along a new leading axis.

    Every array field gains a leading ``len(mats)`` axis while
    ``shape``/``max_row_nnz`` keep the per-element geometry. All inputs must
    share shape, indptr length, nnz capacity, ``max_row_nnz`` and dtype.
    """
    mats = list(mats)
    if not mats:
        raise ValueError("csr_stack needs at least one matrix")
    first = mats[0]
    for m in mats[1:]:
        if (m.shape != first.shape or m.indptr.shape != first.indptr.shape
                or m.indices.shape != first.indices.shape
                or m.max_row_nnz != first.max_row_nnz
                or m.dtype != first.dtype):
            raise ValueError(
                "csr_stack requires uniform padded geometry: "
                f"{m!r} vs {first!r}"
            )
    return CSR(
        indptr=torch.stack([m.indptr for m in mats]),
        indices=torch.stack([m.indices for m in mats]),
        data=torch.stack([m.data for m in mats]),
        shape=first.shape,
        max_row_nnz=first.max_row_nnz,
    )


def csr_unstack(stacked: CSR) -> list:
    """Inverse of ``csr_stack``: split the leading axis back into CSRs."""
    return [
        CSR(stacked.indptr[i], stacked.indices[i], stacked.data[i],
            stacked.shape, stacked.max_row_nnz)
        for i in range(stacked.indptr.shape[0])
    ]


def tensor_residence(t: torch.Tensor) -> str:
    """Where one tensor lives: ``"card"`` (a CUDA device), ``"pinned"``
    (page-locked host memory: the slow level of a run on the card) or
    ``"host"`` (pageable host memory)."""
    if t.device.type == "cuda":
        return "card"
    return "pinned" if t.is_pinned() else "host"


def csr_residence(m: CSR) -> str:
    """:func:`tensor_residence` of a CSR (one matrix or a stack); fields in
    different places raise."""
    places = {tensor_residence(t) for t in (m.indptr, m.indices, m.data)}
    if len(places) != 1:
        raise ValueError(f"CSR fields live in different places: {sorted(places)}")
    return places.pop()


def refuse_pinned(entry: str, *operands) -> None:
    """Raise on an operand in pinned host memory handed to a kernel wrapper
    with no run device (``device=None``): a slow operand of a run on the
    card, which a wrapper reads in place only when the caller names the
    card it runs on (:func:`kernel_device`). The entry points
    (``chunked_spgemm``, ``count_triangles``, ``pipeline_spgemm``,
    ``chunked_spgemm_batched``, ``SpGEMMService``) take one, through the
    copy ring or (``slow_reads="in_place"``) read in place. ``operands`` are
    tensors or CSRs (one matrix or a stack)."""
    if any(t.is_pinned() for t in _tensors(operands)):
        raise ValueError(
            f"{entry}: an operand is in pinned host memory (a slow operand), and "
            "without device= a kernel wrapper reads only the card: put it on the "
            "card with place(x, 'fast'), pass the run device to read it in place, "
            "or call an entry point (chunked_spgemm, chunked_spgemm_batched, "
            "pipeline_spgemm, count_triangles, SpGEMMService), whose copy ring "
            "streams slow operands to the card")


def _tensors(operands) -> list:
    return [t for op in operands
            for t in ((op.indptr, op.indices, op.data) if isinstance(op, CSR) else (op,))]


def kernel_device(entry: str, device, *operands) -> torch.device | None:
    """Where a kernel wrapper runs: ``None`` for its plain version on the
    host, else the card it launches on. With ``device=None`` the first
    operand's device decides, and a pinned host operand raises wherever the
    others lie (:func:`refuse_pinned`). ``device="cpu"`` runs the plain version on host
    operands, pinned or not. A card ``device`` launches there; an operand in
    pinned host memory is then read in place by the kernel (the wrapper's
    ``require(..., in_place=True)`` refuses pageable host memory)."""
    tensors = _tensors(operands)
    if device is None:
        refuse_pinned(entry, *operands)
        return None if tensors[0].device.type == "cpu" else tensors[0].device
    dev = torch.device(device)
    if dev.type == "cpu":
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError(f"{entry}: an operand is on the card in a CPU run")
        return None
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return dev


def reads_host(*operands) -> bool:
    """Whether a launch on the card reads any of ``operands`` (tensors or
    CSRs) in place from host memory."""
    return any(t.device.type == "cpu" for t in _tensors(operands))


def csr_on_one_device(*stacks: CSR) -> tuple:
    """``stacks`` on one device for a wrapper's plan (tensor ops over all of
    them): as they are where they share one, else all on the host, a card
    stack copied there, so that an operand read in place from pinned host
    memory never crosses onto the card to be planned."""
    if len({t.device for t in _tensors(stacks)}) == 1:
        return stacks
    return tuple(CSR(st.indptr.cpu(), st.indices.cpu(), st.data.cpu(), st.shape,
                     st.max_row_nnz) for st in stacks)


def tensor_pin(t: torch.Tensor) -> torch.Tensor:
    """``t`` in pinned host memory: kept if it is there, else copied once."""
    if t.device.type == "cpu" and t.is_pinned():
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def csr_pin(m: CSR) -> CSR:
    """``m`` (one matrix or a stack) in pinned host memory. The ring's copies
    from a pageable source would run synchronously, so every slow stack it
    reads is made here."""
    return CSR(tensor_pin(m.indptr), tensor_pin(m.indices), tensor_pin(m.data),
               m.shape, m.max_row_nnz)


def csr_transpose_host(m: CSR, pad_to: int | None = None) -> CSR:
    """Host-side transpose (multigrid P = R^T), returned on ``m``'s device."""
    indptr = _np(m.indptr)
    indices = _np(m.indices)
    data = _np(m.data)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(m.n_rows), indptr[1:] - indptr[:-1])
    return csr_from_coo(indices[:nnz], rows, data[:nnz], (m.shape[1], m.shape[0]),
                        pad_to, dtype=m.dtype, sum_duplicates=False,
                        device=m.device)
