"""repro_torch.kernels — hand-written CUDA C++ kernels for the H100 (sm_90a).

Each module holds a kernel's wrapper, its plain PyTorch version and its
launch counter; the CUDA sources live in ``csrc/`` and are built by
``_build`` on first use. A wrapper runs the plain version for tensors on the
CPU and launches the kernel for tensors on the card.

Kernels:
  ranged_spgemm        dense-slab ranged multiply-add (backend ``pallas``)
  sparse_accum_spgemm  CSR-output ranged multiply-add, ESC merge (``sparse``)
  hash_accum_spgemm    CSR-output ranged multiply-add, hash merge (``hash``),
                       and its mask-fused variant (``run_masked``, triangles)
  bsr_spgemm           BSR x BSR blocked product (``bsr``, ``ops.bsr_spgemm``)
  bsr_spmm             BSR x dense product (``ops.bsr_spmm``)
  flash_prefill        causal GQA flash attention of a prompt batch
                       (``ops.flash_prefill``, the model's prefill)
  chunked_attention    length-masked decode attention over the KV cache
                       (``ops.decode_attention``, the model's decode step)
  grouped_matmul       ragged grouped GEMM, the MoE experts
                       (``ops.grouped_matmul``, ``ops.grouped_matmul_ragged``)
"""
