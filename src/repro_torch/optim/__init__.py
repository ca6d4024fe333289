"""Optimizers of the LM trainer (:mod:`~repro_torch.optim.adam`)."""
