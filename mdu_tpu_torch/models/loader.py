"""Checkpoint loading (counterpart of ``mdu_tpu/models/loader.py``): a
diffusers-layout folder or a ControlNet checkpoint -> the port's modules
with their weights.

The port's modules keep torch names and layouts (OIHW convs, [out, in]
linears), as the JAX package's do, so conversion is name translation with
no transposes: a ``state_dict`` key with ``.`` read as ``/`` is the JAX
package's parameter path, which the ``translate_*_name`` functions (copied
from the JAX package, pure Python) map to the diffusers key.

Layout on disk, the standard diffusers pipeline folder:
  unet/diffusion_pytorch_model.safetensors (+ config.json)
  vae/diffusion_pytorch_model.safetensors  (+ config.json)
  text_encoder/model.safetensors           (+ config.json)
  tokenizer/vocab.json + merges.txt
  [text_encoder_2/, tokenizer_2/]          SDXL
  [scheduler/scheduler_config.json]
Only local files are read; ``.safetensors`` through the port's own reader
(``models/safetensors.py``), legacy ``.ckpt`` through
``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..device import resolve_device
from . import clip as clip_mod
from . import unet as unet_mod
from . import vae as vae_mod
from .safetensors import load_file


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A flat name -> tensor dict (CPU) from a ``.safetensors`` file or, for a
    legacy pickle ``.ckpt``, through ``torch.load(weights_only=True)`` (no
    code runs), its ``state_dict`` entry if it has one."""
    if path.endswith(".ckpt"):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        return {k: t for k, t in state.items() if isinstance(t, torch.Tensor)}
    return load_file(path)


def _sub_transformer(rest: str) -> str:
    """Our Transformer2D subtree name -> diffusers suffix."""
    m = re.match(r"block_(\d+)/(.*)", rest)
    if m:
        d, inner = m.group(1), m.group(2)
        inner = inner.replace("attn1/to_out", "attn1.to_out.0")
        inner = inner.replace("attn2/to_out", "attn2.to_out.0")
        inner = inner.replace("ff/proj", "ff.net.0.proj")
        inner = inner.replace("ff/out", "ff.net.2")
        inner = inner.replace("/", ".")
        return f"transformer_blocks.{d}.{inner}"
    return rest.replace("/", ".")


def translate_unet_name(name: str) -> str:
    """Our flat UNet param path (sep '/') -> diffusers key (sans .weight/.bias)."""
    parts = name.split("/")
    head = parts[0]

    m = re.match(r"time_embed_(\d)", head)
    if m:
        return f"time_embedding.linear_{m.group(1)}." + parts[-1]
    m = re.match(r"add_embed_(\d)", head)
    if m:
        return f"add_embedding.linear_{m.group(1)}." + parts[-1]
    if head in ("conv_in", "conv_out"):
        return f"{head}." + parts[-1]
    if head == "norm_out":
        return "conv_norm_out." + parts[-1]

    m = re.match(r"(down|up)_(\d+)_res_(\d+)", head)
    if m:
        return (f"{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(3)}."
                + ".".join(parts[1:]))
    m = re.match(r"(down|up)_(\d+)_attn_(\d+)", head)
    if m:
        return (f"{m.group(1)}_blocks.{m.group(2)}.attentions.{m.group(3)}."
                + _sub_transformer("/".join(parts[1:])))
    m = re.match(r"down_(\d+)_downsample", head)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0." + ".".join(parts[1:])
    m = re.match(r"up_(\d+)_upsample", head)
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0." + ".".join(parts[1:])
    m = re.match(r"mid_res_(\d)", head)
    if m:
        return f"mid_block.resnets.{m.group(1)}." + ".".join(parts[1:])
    if head == "mid_attn":
        return "mid_block.attentions.0." + _sub_transformer("/".join(parts[1:]))
    raise KeyError(f"unmapped UNet param: {name}")


def translate_vae_name(name: str) -> str:
    parts = name.split("/")
    head = parts[0]
    if head in ("quant_conv", "post_quant_conv"):
        return f"{head}." + parts[-1]
    coder = head                     # 'encoder' | 'decoder'
    sub = parts[1]
    rest = parts[2:]

    def attn(rest):
        inner = "/".join(rest)
        inner = inner.replace("to_out", "to_out.0")
        return inner.replace("/", ".")

    if sub in ("conv_in", "conv_out"):
        return f"{coder}.{sub}." + rest[-1]
    if sub == "norm_out":
        return f"{coder}.conv_norm_out." + rest[-1]
    m = re.match(r"down_(\d+)_block_(\d+)", sub)
    if m:
        return (f"{coder}.down_blocks.{m.group(1)}.resnets.{m.group(2)}."
                + ".".join(rest))
    m = re.match(r"down_(\d+)_downsample", sub)
    if m:
        return f"{coder}.down_blocks.{m.group(1)}.downsamplers.0." + ".".join(rest)
    m = re.match(r"up_(\d+)_block_(\d+)", sub)
    if m:
        return (f"{coder}.up_blocks.{m.group(1)}.resnets.{m.group(2)}."
                + ".".join(rest))
    m = re.match(r"up_(\d+)_upsample", sub)
    if m:
        return f"{coder}.up_blocks.{m.group(1)}.upsamplers.0." + ".".join(rest)
    if sub == "mid":
        inner = parts[2]
        if inner == "block_1":
            return f"{coder}.mid_block.resnets.0." + ".".join(parts[3:])
        if inner == "block_2":
            return f"{coder}.mid_block.resnets.1." + ".".join(parts[3:])
        if inner == "attn_1":
            return f"{coder}.mid_block.attentions.0." + attn(parts[3:])
    raise KeyError(f"unmapped VAE param: {name}")


def translate_clip_name(name: str) -> str:
    parts = name.split("/")
    head = parts[0]
    if head == "token_embedding":
        return "text_model.embeddings.token_embedding.weight"
    if head == "position_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if head == "ln_final":
        return "text_model.final_layer_norm." + parts[-1]
    if head == "text_projection":
        return "text_projection.weight"
    m = re.match(r"layer_(\d+)", head)
    if m:
        i = m.group(1)
        sub = parts[1]
        leaf = parts[-1]
        table = {"ln1": "layer_norm1", "ln2": "layer_norm2",
                 "q": "self_attn.q_proj", "k": "self_attn.k_proj",
                 "v": "self_attn.v_proj", "out": "self_attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
        return f"text_model.encoder.layers.{i}.{table[sub]}.{leaf}"
    raise KeyError(f"unmapped CLIP param: {name}")


def translate_controlnet_name(name: str) -> str:
    parts = name.split("/")
    head = parts[0]
    if head == "cond_embedding":
        sub = parts[1]
        m = re.match(r"block_(\d+)", sub)
        if m:
            return f"controlnet_cond_embedding.blocks.{m.group(1)}." + parts[-1]
        return f"controlnet_cond_embedding.{sub}." + parts[-1]
    m = re.match(r"zero_(\d+)", head)
    if m:
        return f"controlnet_down_blocks.{m.group(1)}." + parts[-1]
    if head == "zero_mid":
        return "controlnet_mid_block." + parts[-1]
    return translate_unet_name(name)


# VAE checkpoints older than diffusers 0.17 use query/key/value/proj_attn
_VAE_ATTN_ALIASES = {
    "to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn",
}


def convert_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor],
                       translate: Callable[[str], str], strict: bool = True,
                       dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` filled from a checkpoint ``state`` with
    diffusers (or translated) keys: every entry through ``translate`` (its
    name with ``/`` for ``.``), old VAE attention names and [C, C, 1, 1]
    linears accepted, each tensor cast through fp32 to ``dtype`` (default the
    module's own). A missing entry raises under ``strict``; otherwise it is
    left out (the module keeps what it holds)."""
    out, missing = {}, []
    for key, ref in module.state_dict().items():
        name = translate(key.replace(".", "/"))
        t = state.get(name)
        if t is None:
            for ours, old in _VAE_ATTN_ALIASES.items():
                if name.replace(ours, old) in state:
                    t = state[name.replace(ours, old)]
                    break
        if t is None:
            missing.append(name)
            continue
        t = torch.as_tensor(t)
        if tuple(t.shape) != tuple(ref.shape):
            # old-layout VAE attention stores 1x1 convs [C, C, 1, 1] for linears
            if t.dim() == 4 and tuple(t.shape[2:]) == (1, 1) and \
                    tuple(t.shape[:2]) == tuple(ref.shape):
                t = t[:, :, 0, 0]
            else:
                raise ValueError(f"{key}: shape {tuple(t.shape)} != expected "
                                 f"{tuple(ref.shape)}")
        out[key] = t.to(torch.float32).to(dtype or ref.dtype).contiguous()
    if missing and strict:
        raise KeyError(f"missing {len(missing)} params, first: {missing[:5]}")
    return out


def load_module(module: nn.Module, state: Mapping[str, torch.Tensor],
                translate: Callable[[str], str], dtype: torch.dtype, device,
                strict: bool = True) -> nn.Module:
    """Fill ``module`` (built on the meta device, or anywhere) from ``state``
    on ``device`` in ``dtype``. Entries missing under ``strict=False`` are
    zeros, with a warning."""
    sd = convert_state_dict(module, state, translate, strict, dtype)
    missing = [k for k in module.state_dict() if k not in sd]
    if missing:
        print(f"[mdu_tpu_torch] {len(missing)} weights missing from the checkpoint are "
              f"zeros, first: {missing[:5]}", file=sys.stderr)
        ref = module.state_dict()
        sd.update({k: torch.zeros(ref[k].shape, dtype=dtype) for k in missing})
    module.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True, assign=True)
    return module.to(device)


def _read_json(path: str) -> Optional[dict]:
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    return None


def _unet_config_from_json(d: Optional[dict]):
    """diffusers unet/config.json -> UNetConfig (SD1.5 defaults if absent)."""
    cfg = unet_mod.sd15_unet_config()
    if not d:
        return cfg
    bc = tuple(d.get("block_out_channels", cfg.block_out_channels))
    down = d.get("down_block_types", ["CrossAttnDownBlock2D"] * (len(bc) - 1) + ["DownBlock2D"])
    tl = d.get("transformer_layers_per_block", 1)
    if isinstance(tl, int):
        tl = [tl] * len(bc)
    layers = tuple(t if "CrossAttn" in b else 0 for t, b in zip(tl, down))
    head_dim = d.get("attention_head_dim", 8)
    if isinstance(head_dim, (list, tuple)):
        # list = per-block head COUNTS (SD2.x [5,10,20,20], SDXL [5,10,20]):
        # the fixed head dim is channels/heads, 320//5 = 64
        num_heads, hd = None, bc[0] // head_dim[0]
    else:
        # diffusers pre-SD2 used scalar attention_head_dim to mean NUM HEADS (8)
        num_heads, hd = (head_dim, None) if head_dim <= 16 else (None, head_dim)
    return dataclasses.replace(
        cfg,
        in_channels=d.get("in_channels", 4),
        out_channels=d.get("out_channels", 4),
        block_out_channels=bc,
        layers_per_block=d.get("layers_per_block", 2),
        cross_attention_dim=d.get("cross_attention_dim", 768),
        num_heads=num_heads, head_dim=hd,
        transformer_layers=layers,
        use_linear_projection=d.get("use_linear_projection", False),
        addition_embed_type=d.get("addition_embed_type"),
        addition_time_embed_dim=d.get("addition_time_embed_dim", 256),
        addition_pooled_dim=(
            d["projection_class_embeddings_input_dim"]
            - 6 * d.get("addition_time_embed_dim", 256)
            if "projection_class_embeddings_input_dim" in d else 1280),
        norm_num_groups=d.get("norm_num_groups", 32),
    )


def _vae_config_from_json(d: Optional[dict]):
    """diffusers vae/config.json -> VAEConfig (the SD VAE if absent)."""
    cfg = vae_mod.VAEConfig()
    if not d:
        return cfg
    return dataclasses.replace(
        cfg,
        block_out_channels=tuple(d.get("block_out_channels", cfg.block_out_channels)),
        latent_channels=d.get("latent_channels", 4),
        layers_per_block=d.get("layers_per_block", 2),
        norm_num_groups=d.get("norm_num_groups", 32),
        scaling_factor=d.get("scaling_factor", 0.18215),
    )


def _clip_config_from_json(d: Optional[dict], clip_skip: int = 1,
                          ln_penultimate: bool = True):
    """transformers text_encoder/config.json -> CLIPTextConfig (CLIP-L if
    absent)."""
    cfg = clip_mod.clip_l_config()
    if not d:
        return dataclasses.replace(cfg, clip_skip=clip_skip,
                                   ln_penultimate=ln_penultimate)
    return dataclasses.replace(
        cfg,
        vocab_size=d.get("vocab_size", cfg.vocab_size),
        hidden_size=d.get("hidden_size", cfg.hidden_size),
        num_layers=d.get("num_hidden_layers", cfg.num_layers),
        num_heads=d.get("num_attention_heads", cfg.num_heads),
        max_length=d.get("max_position_embeddings", cfg.max_length),
        hidden_act=d.get("hidden_act", cfg.hidden_act),
        projection_dim=d.get("projection_dim") if "projection_dim" in d else cfg.projection_dim,
        clip_skip=clip_skip,
        ln_penultimate=ln_penultimate,
    )


def _schedule_from_json(d: Optional[dict]):
    from ..samplers.schedule import NoiseSchedule

    if not d:
        return None
    return NoiseSchedule(num_train_timesteps=d.get("num_train_timesteps", 1000),
                         beta_start=d.get("beta_start", 0.00085),
                         beta_end=d.get("beta_end", 0.012),
                         beta_schedule=d.get("beta_schedule", "scaled_linear"),
                         prediction_type=d.get("prediction_type", "epsilon"))


def load_pipeline(model_dir: str, dtype: torch.dtype = torch.float32, schedule=None,
                  device=None):
    """(DiffusionPipeline, conditioner) from a diffusers folder on ``device``
    (the card unless the caller names another), weights in ``dtype``. Each
    component's config.json is honoured, SD1.5's defaults where one is
    missing; an SDXL folder (``text_time`` or a ``text_encoder_2``) gives an
    ``SDXLConditioner`` over both encoders, the penultimate states raw
    (SD1/SD2 clip skip LayerNorms them)."""
    from ..pipeline import DiffusionPipeline
    from ..text import CLIPTokenizer, SDXLConditioner, TextConditioner

    device = resolve_device(device)
    ucfg = _unet_config_from_json(_read_json(os.path.join(model_dir, "unet", "config.json")))
    vcfg = _vae_config_from_json(_read_json(os.path.join(model_dir, "vae", "config.json")))
    is_sdxl = ucfg.addition_embed_type == "text_time" or os.path.exists(
        os.path.join(model_dir, "text_encoder_2"))
    ccfg = _clip_config_from_json(
        _read_json(os.path.join(model_dir, "text_encoder", "config.json")),
        clip_skip=2 if is_sdxl else 1, ln_penultimate=not is_sdxl)
    with torch.device("meta"):
        unet = unet_mod.UNet2DCondition(ucfg, dtype=dtype,
                                        layout=unet_mod.default_unet_layout())
        vae = vae_mod.AutoencoderKL(vcfg, dtype=dtype)
        clip = clip_mod.CLIPTextModel(ccfg, dtype=dtype)

    def state(*parts):
        return load_safetensors(os.path.join(model_dir, *parts))

    load_module(unet, state("unet", "diffusion_pytorch_model.safetensors"),
                translate_unet_name, dtype, device)
    load_module(vae, state("vae", "diffusion_pytorch_model.safetensors"),
                translate_vae_name, dtype, device)
    load_module(clip, state("text_encoder", "model.safetensors"), translate_clip_name,
                dtype, device)
    tok = CLIPTokenizer.from_files(os.path.join(model_dir, "tokenizer", "vocab.json"),
                                   os.path.join(model_dir, "tokenizer", "merges.txt"))
    if schedule is None:
        schedule = _schedule_from_json(
            _read_json(os.path.join(model_dir, "scheduler", "scheduler_config.json")))
    pipe = DiffusionPipeline(unet, vae, schedule, device=device)
    conditioner = TextConditioner(clip, tok, device=device)

    te2_dir = os.path.join(model_dir, "text_encoder_2")
    if is_sdxl and os.path.exists(te2_dir):
        ccfg2 = _clip_config_from_json(_read_json(os.path.join(te2_dir, "config.json")),
                                       clip_skip=2, ln_penultimate=False)
        with torch.device("meta"):
            clip2 = clip_mod.CLIPTextModel(ccfg2, dtype=dtype)
        load_module(clip2, load_safetensors(os.path.join(te2_dir, "model.safetensors")),
                    translate_clip_name, dtype, device)
        tok2 = CLIPTokenizer.from_files(                     # OpenCLIP pads with 0
            os.path.join(model_dir, "tokenizer_2", "vocab.json"),
            os.path.join(model_dir, "tokenizer_2", "merges.txt"), pad_with_eot=False)
        conditioner = SDXLConditioner(conditioner,
                                      TextConditioner(clip2, tok2, device=device))
    return pipe, conditioner


def load_controlnet(path: str, unet_cfg=None, dtype: torch.dtype = torch.float32,
                    conditioning_scale: float = 1.0, device=None):
    """A ControlNet with its weights on ``device``, from a diffusers folder
    (config.json + diffusion_pytorch_model.safetensors; its config wins) or
    a bare ``.safetensors`` with diffusers keys (``unet_cfg``, the paired
    UNet's config, else SD1.5's)."""
    from .controlnet import ControlNet

    device = resolve_device(device)
    if os.path.isdir(path):
        cfg_json = _read_json(os.path.join(path, "config.json"))
        state = load_safetensors(os.path.join(path, "diffusion_pytorch_model.safetensors"))
        cfg = (_unet_config_from_json(cfg_json) if cfg_json
               else unet_cfg or unet_mod.sd15_unet_config())
    else:
        state = load_safetensors(path)
        cfg = unet_cfg or unet_mod.sd15_unet_config()
    with torch.device("meta"):
        cn = ControlNet(cfg, conditioning_scale=conditioning_scale, dtype=dtype)
    return load_module(cn, state, translate_controlnet_name, dtype, device)


def load_guidance(path: str, unet_cfg, dtype: torch.dtype = torch.float32,
                  guidance_scale: float = 1.0, device=None):
    """StableSR's guidance encoder (``models/stablesr.py``) with its weights on
    ``device``, from a ``.safetensors`` keyed by the JAX package's flat
    parameter paths (``down_0_res_0/norm1/weight``; the layout
    ``mdu_tpu/models/loader.py:459-480`` reads and
    ``scripts/export_params.py`` writes)."""
    from .stablesr import StableSRGuidance

    device = resolve_device(device)
    state = load_safetensors(path)
    with torch.device("meta"):
        gm = StableSRGuidance(unet_cfg, guidance_scale=guidance_scale, dtype=dtype)
    return load_module(gm, state, lambda name: name, dtype, device)


def load_model(path: str, dtype: torch.dtype = torch.float32, device=None,
               tokenizer_dir: Optional[str] = None):
    """(DiffusionPipeline, conditioner) from a diffusers folder or an A1111
    single file (``.safetensors`` / ``.ckpt``, LDM naming), as the command
    line's ``--model-dir`` takes either."""
    if path.endswith((".safetensors", ".ckpt")):
        from .single_file import load_single_file

        return load_single_file(path, dtype=dtype, tokenizer_dir=tokenizer_dir, device=device)
    return load_pipeline(path, dtype=dtype, device=device)
