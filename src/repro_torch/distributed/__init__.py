"""Distributed training over ``torch.distributed`` ranks (port of
``repro.distributed``): sharding rules and their DTensor placements
(:mod:`~repro_torch.distributed.sharding`), activation constraints
(:mod:`~repro_torch.distributed.act_sharding`), the counted collectives
and the hierarchical all-reduce
(:mod:`~repro_torch.distributed.collectives`) and the GPipe pipeline
(:mod:`~repro_torch.distributed.pipeline`).  The data-parallel trainer is
``repro_torch.train.loop.make_dp_train_step``; ranks on one machine come
from ``repro_torch.launch.mesh.spawn_ranks``.

The reference's ``repro/compat.py`` (JAX-version shims for ``shard_map``,
``pcast`` and ``axis_size``) has no counterpart."""
