"""Trainer snapshot state (the MT19937 stream pack)."""
