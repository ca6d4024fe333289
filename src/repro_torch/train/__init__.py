"""Training infrastructure shared by the job runtime: atomic checkpoints
(:mod:`~repro_torch.train.checkpoint`) and the straggler monitor
(:mod:`~repro_torch.train.fault_tolerance`)."""
