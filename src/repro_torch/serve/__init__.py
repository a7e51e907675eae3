"""repro_torch.serve — the SpGEMM service: many small C = A x B requests
behind one endpoint, bucketed by padded geometry and run through
``chunked_spgemm_batched`` on the operands' device."""

from repro_torch.serve.spgemm_service import (
    AdmissionError, SpGEMMFuture, SpGEMMRequest, SpGEMMResponse, SpGEMMService,
    ServiceStats, plan_key,
)

__all__ = [
    "AdmissionError", "SpGEMMFuture", "SpGEMMService", "SpGEMMRequest",
    "SpGEMMResponse", "ServiceStats", "plan_key",
]
