"""Tile geometry and image helpers of the port."""
