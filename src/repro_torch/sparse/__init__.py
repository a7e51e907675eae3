from repro_torch.sparse.csr import (
    CSR, GeometryEnvelope, csr_from_dense, csr_to_dense, csr_from_coo,
    csr_pad_to, resolve_device,
)
from repro_torch.sparse import bsr, generators, graphs, multigrid

__all__ = [
    "CSR", "GeometryEnvelope", "csr_from_dense", "csr_to_dense",
    "csr_from_coo", "csr_pad_to", "resolve_device",
    "bsr", "generators", "graphs", "multigrid",
]
