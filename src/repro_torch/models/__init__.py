"""The LM stack's dense decoder (port of ``repro.models``, serving path).

  layers       norms, rotary embeddings, linears, the MLP
  quantized    the int8 serve-path linear (``quantize_dense``)
  attention    GQA attention, the KV cache, decode
  transformer  the decoder: forward, prefill, decode step
  api          ``Model`` and ``params_from_jax``
"""
