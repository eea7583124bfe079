"""The yardstick's arithmetic: the published H100 SXM peaks, an attention
call's least time, and the model operations of one image, counted from the
benchmark's own plan and plain modules (never from the program).

A UNet call is counted at its batch and tile size: ``FlopCounterMode`` over
the plain UNet on the meta device for the convolutions and linears, plus
``4 * B * H * Lq * Lk * D`` for each attention. The VAE is counted at the
whole image's size (no halo, no padded repeat), its mid-block attention
over each tile's owned tokens.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def attention_least_s(B: int, H: int, Lq: int, Lk: int, D: int, itemsize: int) -> float:
    """max(operations / peak, bytes of q, k, v read once and o written once
    / bandwidth)."""
    ops = 4.0 * B * H * Lq * Lk * D
    nbytes = float(itemsize) * B * H * D * (2 * Lq + 2 * Lk)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def _counted(fn) -> Tuple[float, float]:
    """(products' flops under FlopCounterMode, attention flops recorded)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        attn = fn()
    return float(counter.get_total_flops()), attn


def _spec_key(d: dict) -> str:
    import json
    return json.dumps(d, sort_keys=True)


@lru_cache(maxsize=64)
def unet_call_flops(unet_json: str, B: int, h: int, w: int, tokens: int,
                    pooled: int) -> float:
    import json

    from ..reference.nets import Precision, build

    spec = json.loads(unet_json)
    unet = build("unet", spec)
    p = Precision("count")
    dev = "meta"

    def run():
        x = torch.zeros(B, spec.get("in_channels", 4), h, w, device=dev)
        t = torch.zeros(B, device=dev)
        ctx = torch.zeros(B, tokens, spec["cross_attention_dim"], device=dev)
        te = torch.zeros(B, pooled, device=dev) if pooled else None
        tid = torch.zeros(B, spec.get("num_time_ids", 6), device=dev) if pooled else None
        unet(p, x, t, ctx, te, tid)
        return p.attention_flops

    mm, attn = _counted(run)
    return mm + attn


@lru_cache(maxsize=16)
def vae_flops(vae_json: str, which: str, h: int, w: int) -> float:
    """Convolutions and linears of a decode of an [h, w] latent (``which`` =
    "decode") or an encode of an [h, w] image ("encode"), untiled, without
    attention."""
    import json

    from ..reference.nets import Precision, build

    spec = json.loads(vae_json)
    vae = build("vae", spec)
    p = Precision("count")

    def run():
        if which == "decode":
            vae.decode(p, torch.zeros(1, spec.get("latent_channels", 4), h, w, device="meta"))
        else:
            vae.encode_moments(p, torch.zeros(1, spec.get("in_channels", 3), h, w,
                                              device="meta"))
        return 0.0

    return _counted(run)[0]


def vae_attention_flops(h: int, w: int, tile: int, pad: int, channels: int,
                        scale: int) -> float:
    """The mid-block attention over each tile's owned tokens: ``scale`` =
    1 for the decoder (owned latent pixels), 8 for the encoder (owned image
    pixels / 8 a side)."""
    from ..reference.diffusion import vae_plan

    vp = vae_plan(h, w, tile, pad)
    owned = [(h, w)] if vp is None else [(y1 - y0, x1 - x0) for y0, y1, x0, x1 in vp.owned]
    return sum(4.0 * (oh // scale * (ow // scale)) ** 2 * channels for oh, ow in owned)


def unet_calls(workload: dict) -> List[Tuple[int, int, int]]:
    """(batch, h, w) of every UNet call of one image, from the benchmark's
    own copy of the plan."""
    from ..reference.diffusion import plan

    td, sp = workload["tiled_diffusion"], workload["sampler"]
    if workload["entry"] == "img2img":
        s = int(workload["image"]["size"] * td["scale_factor"]) // 8
        h = w = s
    else:
        h, w = workload["height"] // 8, workload["width"] // 8
    tp = plan(td["method"], h, w, td["tile_w"], td["overlap"], td["tile_bs"],
              td.get("regions", ()))
    grid = [(len(bb), tp.tile_h, tp.tile_w) for bb in tp.batched]
    regions = [(1, r.h, r.w) for r in tp.regions]
    guided = [(2 * b, th, tw) for b, th, tw in grid + regions]
    calls: List[Tuple[int, int, int]] = []
    if workload["entry"] == "img2img":
        steps = int(min(sp["denoising_strength"], 0.999) * sp["steps"]) + 1
        if td.get("noise_inverse"):
            calls += (grid + regions) * td["noise_inverse_steps"]
    else:
        steps = sp["steps"]
    return calls + guided * steps


def image_flops(workload: dict, config: dict) -> Dict[str, float]:
    """Model operations of one image: {"unet", "vae", "total"}."""
    from ..reference.diffusion import DECODER_PAD, ENCODER_PAD

    u, v = _spec_key(config["unet"]), _spec_key(config["vae"])
    c = workload["conds"]
    unet = sum(unet_call_flops(u, b, h, w, c["tokens"], c.get("pooled", 0))
               for b, h, w in unet_calls(workload))
    td, tv = workload["tiled_diffusion"], workload["tiled_vae"]
    width = config["vae"].get("block_out_channels", [128, 256, 512, 512])[-1]
    if workload["entry"] == "img2img":
        S = int(workload["image"]["size"] * td["scale_factor"]) // 8 * 8
        lh = lw = S // 8
        vae = (vae_flops(v, "encode", S, S)
               + vae_attention_flops(S, S, tv["encoder_tile_size"], ENCODER_PAD, width, 8))
    else:
        lh, lw = workload["height"] // 8, workload["width"] // 8
        vae = 0.0
    vae += (vae_flops(v, "decode", lh, lw)
            + vae_attention_flops(lh, lw, tv["decoder_tile_size"], DECODER_PAD, width, 1))
    return {"unet": unet, "vae": vae, "total": unet + vae}
