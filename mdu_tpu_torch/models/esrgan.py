"""RRDBNet (ESRGAN x4), the GAN pre-upscaler of img2img (counterpart of
``mdu_tpu/models/esrgan.py``, with its module names).

Residual-in-residual dense blocks, then two nearest x2 repeats each followed
by a conv, LeakyReLU 0.2 throughout. ``load_esrgan`` reads new-arch
(``conv_first`` / ``body.N.rdbK.convJ`` / ``conv_body`` / ``conv_up1`` ...)
and old-arch (``model.0`` / ``model.1.sub.N.RDBK.convJ.0`` ...) checkpoints
and infers the widths and depth from the file; ``register_esrgan_upscaler``
puts the model in the upscaler registry (``upscale.py``). The convs are
plain convolutions in the JAX package too (XLA, no Pallas kernel), so here
they are cuDNN's, through ``F.conv2d``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2D


@dataclass(frozen=True)
class RRDBNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 64
    num_blocks: int = 23
    grow: int = 32
    scale: int = 4


def tiny_rrdb_config() -> RRDBNetConfig:
    return RRDBNetConfig(num_feat=8, num_blocks=2, grow=4)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, cfg: RRDBNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, g = cfg.num_feat, cfg.grow
        for k in range(4):
            self.add_module(f"conv{k + 1}", Conv2D(nf + k * g, g, dtype=dtype))
        self.conv5 = Conv2D(nf + 4 * g, nf, dtype=dtype)

    def forward(self, x):
        feats = [x]
        for k in range(1, 5):
            feats.append(_lrelu(getattr(self, f"conv{k}")(torch.cat(feats, 1))))
        return x + 0.2 * self.conv5(torch.cat(feats, 1))


class RRDB(nn.Module):
    def __init__(self, cfg: RRDBNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(cfg, dtype)
        self.rdb2 = ResidualDenseBlock(cfg, dtype)
        self.rdb3 = ResidualDenseBlock(cfg, dtype)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """[B, 3, H, W] in [0, 1] -> [B, 3, 4H, 4W] in [0, 1]."""

    def __init__(self, cfg: RRDBNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        nf = cfg.num_feat
        self.conv_first = Conv2D(cfg.in_channels, nf, dtype=dtype)
        for i in range(cfg.num_blocks):
            self.add_module(f"body_{i}", RRDB(cfg, dtype))
        self.conv_body = Conv2D(nf, nf, dtype=dtype)
        self.conv_up1 = Conv2D(nf, nf, dtype=dtype)
        self.conv_up2 = Conv2D(nf, nf, dtype=dtype)
        self.conv_hr = Conv2D(nf, nf, dtype=dtype)
        self.conv_last = Conv2D(nf, cfg.out_channels, dtype=dtype)

    def forward(self, x):
        feat = self.conv_first(x)
        h = feat
        for i in range(self.cfg.num_blocks):
            h = getattr(self, f"body_{i}")(h)
        h = feat + self.conv_body(h)
        h = _lrelu(self.conv_up1(h.repeat_interleave(2, 2).repeat_interleave(2, 3)))
        h = _lrelu(self.conv_up2(h.repeat_interleave(2, 2).repeat_interleave(2, 3)))
        return self.conv_last(_lrelu(self.conv_hr(h)))


def translate_esrgan_name(name: str) -> str:
    """A flat parameter path (``/``-separated, the JAX package's) -> its
    new-arch ESRGAN key."""
    parts = name.split("/")
    head = parts[0]
    if head.startswith("body_"):
        i = head.split("_")[1]
        return f"body.{i}.{parts[1]}.{parts[2]}.{parts[3]}"
    return f"{head}." + parts[-1]


_OLD_ARCH = {"conv_first": "model.0", "conv_up1": "model.3", "conv_up2": "model.6",
             "conv_hr": "model.8", "conv_last": "model.10"}


def _old_arch_name(name: str, num_blocks: int) -> str:
    """A flat parameter path -> its old-arch ESRGAN key."""
    parts = name.split("/")
    head = parts[0]
    if head.startswith("body_"):
        i = head.split("_")[1]
        return f"model.1.sub.{i}.{parts[1].upper()}.{parts[2]}.0.{parts[3]}"
    trunk = dict(_OLD_ARCH, conv_body=f"model.1.sub.{num_blocks}")
    return trunk[head] + "." + parts[-1]


def load_esrgan(path: str, cfg: Optional[RRDBNetConfig] = None,
                dtype: torch.dtype = torch.float32, device=None) -> RRDBNet:
    """An ESRGAN x4 ``.safetensors`` checkpoint, new-arch or old-arch keys ->
    an ``RRDBNet`` with its weights on ``device`` (the card by default);
    without ``cfg`` the widths and the depth come from the file."""
    from .loader import load_module
    from .safetensors import load_file

    state = load_file(path)
    old_arch = any(k.startswith("model.0") for k in state)
    if cfg is None:
        first = state["model.0.weight" if old_arch else "conv_first.weight"]
        g_key = "model.1.sub.0.RDB1.conv1.0.weight" if old_arch else "body.0.rdb1.conv1.weight"
        if old_arch:
            idx = [int(k.split(".")[3]) for k in state
                   if k.startswith("model.1.sub.") and "RDB" in k]
        else:
            idx = [int(k.split(".")[1]) for k in state if k.startswith("body.")]
        cfg = RRDBNetConfig(num_feat=int(first.shape[0]), num_blocks=max(idx) + 1,
                            grow=int(state[g_key].shape[0]))
    with torch.device("meta"):
        model = RRDBNet(cfg, dtype=dtype)
    if old_arch:
        def translate(name):
            return _old_arch_name(name, cfg.num_blocks)
    else:
        translate = translate_esrgan_name
    return load_module(model, state, translate, dtype, resolve_device(device)).eval()


def esrgan_upscaler(model: RRDBNet):
    """The upscaler ``(x [B, 3, H, W] in [-1, 1], scale) -> [B, 3, int(H *
    scale), int(W * scale)]`` of ``model``: [-1, 1] -> [0, 1], the model on
    its device and in its dtype, back to [-1, 1] as fp32 on ``x``'s device,
    then a Lanczos resample where the request is not x4."""
    from ..ops.resize import resize_nchw

    dev = next(model.parameters()).device

    @torch.inference_mode()
    def fn(x, scale):
        img01 = ((x + 1.0) * 0.5).to(dev)
        up = model(img01).float().to(x.device) * 2.0 - 1.0
        target = (int(x.shape[-2] * scale), int(x.shape[-1] * scale))
        if tuple(up.shape[-2:]) != target:
            up = resize_nchw(up, target, "lanczos")
        return up

    return fn


def register_esrgan_upscaler(name: str, path: str, cfg: Optional[RRDBNetConfig] = None,
                             dtype: torch.dtype = torch.float32, device=None) -> RRDBNet:
    """Load a checkpoint and register it as upscaler ``name``, so that
    ``TiledDiffusionConfig(upscaler=name)`` pre-upscales with it. Returns
    the model."""
    from ..upscale import register_upscaler

    model = load_esrgan(path, cfg, dtype, device)
    register_upscaler(name, esrgan_upscaler(model))
    return model
