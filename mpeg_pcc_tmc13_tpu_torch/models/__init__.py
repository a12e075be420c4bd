"""Codec-family state the device pipeline needs (entropy contexts,
attribute step sizes)."""
