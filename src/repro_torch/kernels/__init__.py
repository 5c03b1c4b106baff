"""Hand-written CUDA kernels for Hopper (sm_90a) with plain PyTorch twins.

  tile_spmm/        COO and CSR tile SpMM + the online segment softmax
                    (csrc/tile_spmm.cu, kernel.py ctypes wrappers, ref.py
                    plain versions, ops.py operand prep + dispatch)
  segment_softmax/  re-exports of the softmax half under its own name
  flash_attention/  blocked online-softmax attention (GQA, causal/window,
                    kv_len, Dv != D) for the LM stack
  moe_dispatch/     MoE routing/dispatch/combine + the grouped SwiGLU FFN
                    over expert capacity buckets
"""
