#!/usr/bin/env python3
"""Bytes the stream-host mode of the streaming exact tiled VAE moves for one
tile: the SD VAE's op walk (``tiling/streaming_vae.py``) run on the meta
device, segment by segment, summing what each boundary carries (the
activation and, where it lives across the boundary, the residual) down to
the host and back up, and the largest carry. No device and no weights.

    python3 scripts/stream_traffic.py [--decoder-tile 86] [--encoder-tile 1056]

The tile sides are the padded input tiles: 86 latent pixels for decoder
tile 64 (config 3 and the 8K), 1056 pixels for config 3's encoder tile 1024.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mdu_tpu_torch.models import AutoencoderKL, VAEConfig  # noqa: E402
from mdu_tpu_torch.tiling import streaming_vae as sv  # noqa: E402


def traffic(vae, which: str, side: int, itemsize: int = 2):
    """(bytes down and up a tile, the largest carry a tile, segments)."""
    ops = sv.decoder_ops(vae) if which == "decoder" else sv.encoder_ops(vae)
    spans = sv._carry_spans([k for k, _ in ops])
    G = vae.cfg.norm_num_groups
    x = torch.empty(1, 4 if which == "decoder" else 3, side, side, device="meta",
                    dtype=vae.dtype)
    stats = (torch.empty(1, G, device="meta"), torch.empty(1, G, device="meta"))
    mask = torch.empty(1, 1, side, side, device="meta")
    res, total, peak = None, 0, 0
    for i, (a, b) in enumerate(spans):
        x, res, _ = sv._run_segment(ops[a:b], G, x, res, mask, stats, False)
        if i < len(spans) - 1:
            carry = (x.numel() + (res.numel() if res is not None else 0)) * itemsize
            total += 2 * carry
            peak = max(peak, carry)
    return total, peak, len(spans)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decoder-tile", type=int, default=86)
    ap.add_argument("--encoder-tile", type=int, default=1056)
    args = ap.parse_args()
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig(), dtype=torch.bfloat16)
    for which, side in (("decoder", args.decoder_tile), ("encoder", args.encoder_tile)):
        total, peak, n = traffic(vae, which, side)
        print(f"{which} tile {side}: {n} segments, {total / 1e9:.2f} GB down and up, "
              f"largest carry {peak / 1e6:.1f} MB (bf16)")


if __name__ == "__main__":
    main()
