"""repro_torch.core — the paper's primary contribution, in PyTorch.

KKMEM two-phase SpGEMM (``kkmem``), selective data placement (``placement``),
the chunked multilevel-memory algorithms 1-4 (``planner``, ``chunking``,
``chunk_stream``), locality analysis (``locality``) and the two-level memory
cost model (``memory_model``). Import the submodules directly.
"""
