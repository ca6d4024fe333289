"""EMB: bank-sharded embedding training with deferred sparse updates.

Port of ``repro.emb``: dot-product embedding regression over (user,
item) index pairs, the memory-bound recommender pattern LazyDP
accelerates with lazily deferred updates, on the System protocol with
the ``emb_gather`` / ``emb_scatter_add`` kernels.
"""
from .trainer import (EmbConfig, EmbResult, VERSIONS, fit,  # noqa: F401
                      fit_steps)
