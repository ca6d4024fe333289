"""The kernel tier: hand-written CUDA kernels behind plain PyTorch twins.

  dispatch        op registry and per-op launch counts; the tensor's
                  device picks the implementation
  build           nvcc build of ``csrc/*.cu`` at first use, ctypes binding
  quant_matmul    ``fx_matvec`` (Q-format matvec of LIN/LOG INT32),
                  ``int_matmul`` and ``quant_matmul`` (the int8 linears of
                  the LM stack's ``quantize_dense`` path)
  lut_activation  ``lut_sigmoid`` (LUT sigmoid of LOG, WRAM/MRAM)
  kmeans_assign   ``kmeans_assign`` (assign + accumulate of KME int16)
  gini_split      ``gini_split`` (split-evaluate counts of DTR)
  sparse_gather   ``emb_gather`` and ``emb_scatter_add`` (the sharded
                  embedding row lookup and update of EMB)
  flash_attention ``mha`` (GQA attention forward of LM prefill and
                  training) and ``mha_bwd`` (its gradient, for training)
"""
