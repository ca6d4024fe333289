"""The LM stack's dense decoder (port of ``repro.models``: serving and
training).

  layers       norms, rotary embeddings, linears, the MLP, LUT activations
  quantized    the int8 linear (``quantize_dense``), ``fake_quant_dense``
  attention    GQA attention, the KV cache, decode
  transformer  the decoder: forward, ``lm_loss``, prefill, decode step
  api          ``Model`` and ``params_from_jax``
"""
