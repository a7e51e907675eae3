"""repro_torch: the multilevel-memory SpGEMM (Deveci et al. 2018) in PyTorch for an H100.

A port of the JAX package ``repro`` with the same layout and names. It imports
``torch`` and ``numpy`` only. Tensors live on the card unless a caller passes
``device="cpu"``; every Pallas kernel of the main path is a CUDA C++ kernel
for ``sm_90a`` under ``kernels/csrc/``, with a plain PyTorch version beside it.

Layers:
  repro_torch.sparse   -- CSR container, envelopes, problem generators
  repro_torch.core     -- KKMEM SpGEMM, placement, planner, chunked executors
  repro_torch.kernels  -- the hand-written CUDA kernels, their wrappers and
                          plain versions
"""

__version__ = "0.1.0"
