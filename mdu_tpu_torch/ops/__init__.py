"""Attention, GroupNorm and tile-fusion ops of the port."""
