"""Synthetic datasets and LM token streams (numpy only), made from a
seed, and the prefetching loader that places batches on a device."""
