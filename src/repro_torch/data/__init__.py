"""Synthetic datasets (numpy only), made from a seed."""
