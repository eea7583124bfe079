"""MultiDiffusion tile scheduler, per-tile conds and the exact tiled VAE decode."""
