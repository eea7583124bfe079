"""What a run makes from its ``--seed``: the weights, the conds, each image's
seed and, for img2img, each image's input. Both the program and the
reference are handed these same tensors."""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

ALIGN = 128           # elements: every weight starts on a 256-byte boundary in bf16

# tags of the draws derived from the run's seed
TAG_WEIGHTS, TAG_CONDS, TAG_CHECK, TAG_IMAGE = 1, 2, 3, 10_000


def derive(seed: int, tag: int, bits: int = 31) -> int:
    """A seed below 2^bits from (seed, tag), every bit of ``seed`` mixed in."""
    word = np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0]
    return int(word) % 2**bits


def image_seed(seed: int, k: int) -> int:
    return derive(seed, TAG_IMAGE + k)


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, dtype,
                 device) -> Dict[str, torch.Tensor]:
    """Random weights in the serving dtype, drawn on ``device`` in one call:
    uniform +-sqrt(3 / fan_in) for every tensor of two or more dimensions
    (variance 1 / fan_in), zero biases, unit norm scales."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, TAG_WEIGHTS))
    offsets, total = [], 0
    for name, shape in shapes:
        if len(shape) > 1:
            offsets.append(total)
            total += -(-math.prod(shape) // ALIGN) * ALIGN
        else:
            offsets.append(None)
    flat = torch.rand(max(total, 1), generator=gen, dtype=dtype, device=device)
    out = {}
    for (name, shape), off in zip(shapes, offsets):
        if off is None:
            fill = 0.0 if name.endswith("bias") else 1.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
            continue
        bound = math.sqrt(3.0 / max(1, math.prod(shape[1:])))
        t = flat[off:off + math.prod(shape)].view(shape)
        out[name] = t.mul_(2 * bound).sub_(bound)
    return out


def make_conds(workload: dict, config: dict, seed: int, dtype, device) -> dict:
    """cond, uncond and each region's (cond, uncond): random text
    embeddings [1, 77, D] x 0.1 (and SDXL's pooled [1, P] x 0.1 with the
    workload's time_ids), drawn on ``device`` from the seed; the text
    encoders are not on the timed path."""
    c = workload["conds"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, TAG_CONDS))
    scale = float(c.get("scale", 0.1))

    def one():
        d = {"crossattn": (torch.randn(1, c["tokens"], config["unet"]["cross_attention_dim"],
                                       generator=gen, device=device) * scale).to(dtype)}
        if "pooled" in c:
            d["vector"] = (torch.randn(1, c["pooled"], generator=gen, device=device)
                           * scale).to(dtype)
        if "time_ids" in c:
            d["time_ids"] = torch.tensor([c["time_ids"]], dtype=torch.float32, device=device)
        return d

    cond, uncond = one(), one()
    regions = [(one(), uncond) for _ in workload["tiled_diffusion"].get("regions", ())]
    return {"cond": cond, "uncond": uncond, "regions": regions}


def make_image(workload: dict, seed: int) -> np.ndarray:
    """img2img's input, uint8 [S, S, 3], uniform noise from the image's seed."""
    s = int(workload["image"]["size"])
    return np.random.default_rng(seed).integers(0, 256, (s, s, 3), dtype=np.uint8)
