"""The LM stack, every family (port of ``repro.models``: serving and
training).

  layers       norms, rotary and sinusoidal positions, linears, the MLP,
               LUT activations
  quantized    the int8 linear (``quantize_dense``), ``fake_quant_dense``
  attention    GQA attention (sliding windows), cross-attention, the KV
               cache, decode
  moe          the Mixture-of-Experts layer (gather and dense dispatch)
  ssm          xLSTM's mLSTM and sLSTM, the selective SSM of Hymba
  transformer  the decoder: forward, ``lm_loss``, prefill, decode step
  encdec       the audio family's encoder-decoder
  api          ``Model`` and ``params_from_jax``
"""
