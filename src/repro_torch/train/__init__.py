"""Training infrastructure: atomic checkpoints
(:mod:`~repro_torch.train.checkpoint`), straggler detection and recovery
(:mod:`~repro_torch.train.fault_tolerance`) and the LM training steps
(:mod:`~repro_torch.train.loop`)."""
