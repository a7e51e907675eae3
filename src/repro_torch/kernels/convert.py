"""Carry state across from the JAX package: build the port's objects from the
fields of the reference's, given as NumPy arrays and Python values.

Nothing here imports the JAX package; a caller holding a reference ``CSR``
passes ``np.asarray`` of its arrays. The fields are taken as they are
(``max_row_nnz`` included), so a converted CSR is bitwise the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.planner import ChunkPlan
from repro_torch.sparse.csr import CSR, resolve_device


def csr_from_fields(indptr, indices, data, shape, max_row_nnz: int,
                    device=None) -> CSR:
    """A port CSR holding exactly these arrays (int32 indices, the data's
    float dtype)."""
    device = resolve_device(device)
    return CSR(
        indptr=torch.from_numpy(np.array(indptr, dtype=np.int32)).to(device),
        indices=torch.from_numpy(np.array(indices, dtype=np.int32)).to(device),
        data=torch.from_numpy(np.array(data)).to(device),
        shape=(int(shape[0]), int(shape[1])),
        max_row_nnz=int(max_row_nnz),
    )


def csr_fields(m: CSR) -> dict:
    """The port CSR's fields as NumPy arrays and Python values (the inverse
    of :func:`csr_from_fields`)."""
    return {"indptr": m.indptr.cpu().numpy(), "indices": m.indices.cpu().numpy(),
            "data": m.data.cpu().numpy(), "shape": tuple(m.shape),
            "max_row_nnz": int(m.max_row_nnz)}


def plan_from_fields(algorithm: str, p_ac, p_b, copy_bytes: float,
                     fast_bytes_needed: float) -> ChunkPlan:
    """A port ChunkPlan with the reference plan's fields."""
    return ChunkPlan(str(algorithm), tuple(int(v) for v in p_ac),
                     tuple(int(v) for v in p_b), float(copy_bytes),
                     float(fast_bytes_needed))
