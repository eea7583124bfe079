"""Single-file (CompVis / LDM layout) checkpoints (counterpart of
``mdu_tpu/models/single_file.py``).

A1111's users load one ``.safetensors`` (or ``.ckpt``) with LDM names
(``model.diffusion_model.*``, ``first_stage_model.*``, ``cond_stage_model.*``
or SDXL's ``conditioner.embedders.*``). This module maps those names onto the
diffusers keys that ``models/loader.py`` translates, so ``load_single_file``
builds the pipeline ``load_pipeline`` builds from a folder. Supported: SD1.x
and SD2.x (UNet, VAE, CLIP-L or OpenCLIP-H) and SDXL (UNet, VAE, CLIP-L and
OpenCLIP-bigG). OpenCLIP towers store a fused qkv ``in_proj``, split here.
The key maps are copied from the JAX package (pure Python).
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import Dict, Optional

import torch

from ..device import resolve_device
from . import clip as clip_mod
from . import unet as unet_mod
from . import vae as vae_mod
from .loader import (load_module, load_safetensors, translate_clip_name, translate_unet_name,
                     translate_vae_name)

# ------------------------------------------------------------- UNet names


def _ldm_resnet_sub(rest: str) -> str:
    table = {
        "in_layers.0": "norm1", "in_layers.2": "conv1",
        "emb_layers.1": "time_emb_proj",
        "out_layers.0": "norm2", "out_layers.3": "conv2",
        "skip_connection": "conv_shortcut",
    }
    for k, v in table.items():
        if rest.startswith(k):
            return v + rest[len(k):]
    return rest


def ldm_unet_key_to_diffusers(key: str, n_levels: int = 4,
                              layers_per_block: int = 2) -> Optional[str]:
    """'model.diffusion_model.x' -> diffusers UNet key (None = skip)."""
    if not key.startswith("model.diffusion_model."):
        return None
    k = key[len("model.diffusion_model."):]
    per = layers_per_block + 1

    m = re.match(r"time_embed\.(\d)\.(.*)", k)
    if m:
        return f"time_embedding.linear_{int(m.group(1)) // 2 + 1}.{m.group(2)}"
    m = re.match(r"label_emb\.0\.(\d)\.(.*)", k)           # SDXL add embedding
    if m:
        return f"add_embedding.linear_{int(m.group(1)) // 2 + 1}.{m.group(2)}"
    if k.startswith("input_blocks.0.0."):
        return "conv_in." + k[len("input_blocks.0.0."):]
    if k.startswith("out.0."):
        return "conv_norm_out." + k[len("out.0."):]
    if k.startswith("out.2."):
        return "conv_out." + k[len("out.2."):]

    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", k)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        level, j = (idx - 1) // per, (idx - 1) % per
        if j == layers_per_block:                    # the downsample slot
            if rest.startswith("op."):
                return f"down_blocks.{level}.downsamplers.0.conv." + rest[3:]
            return None
        if sub == 0:
            return f"down_blocks.{level}.resnets.{j}." + _ldm_resnet_sub(rest)
        return f"down_blocks.{level}.attentions.{j}." + rest

    m = re.match(r"middle_block\.(\d)\.(.*)", k)
    if m:
        sub, rest = int(m.group(1)), m.group(2)
        if sub == 0:
            return "mid_block.resnets.0." + _ldm_resnet_sub(rest)
        if sub == 1:
            return "mid_block.attentions.0." + rest
        return "mid_block.resnets.1." + _ldm_resnet_sub(rest)

    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", k)
    if m:
        idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        level, j = idx // per, idx % per
        if sub == 0:
            return f"up_blocks.{level}.resnets.{j}." + _ldm_resnet_sub(rest)
        # sub >= 1 is either an attention or the upsample conv
        if rest.startswith("conv."):
            return f"up_blocks.{level}.upsamplers.0." + rest
        return f"up_blocks.{level}.attentions.{j}." + rest
    return None


# -------------------------------------------------------------- VAE names


def ldm_vae_key_to_diffusers(key: str, n_levels: int = 4) -> Optional[str]:
    """'first_stage_model.x' -> diffusers VAE key."""
    if not key.startswith("first_stage_model."):
        return None
    k = key[len("first_stage_model."):]
    if k.startswith(("quant_conv.", "post_quant_conv.")):
        return k
    for coder in ("encoder", "decoder"):
        if not k.startswith(coder + "."):
            continue
        r = k[len(coder) + 1:]
        r = r.replace("nin_shortcut", "conv_shortcut")
        r = r.replace("norm_out", "conv_norm_out")
        m = re.match(r"down\.(\d+)\.block\.(\d+)\.(.*)", r)
        if m:
            return f"{coder}.down_blocks.{m.group(1)}.resnets.{m.group(2)}.{m.group(3)}"
        m = re.match(r"down\.(\d+)\.downsample\.conv\.(.*)", r)
        if m:
            return f"{coder}.down_blocks.{m.group(1)}.downsamplers.0.conv.{m.group(2)}"
        m = re.match(r"up\.(\d+)\.block\.(\d+)\.(.*)", r)
        if m:
            # LDM decoder indexes up blocks in REVERSE of diffusers
            lvl = n_levels - 1 - int(m.group(1))
            return f"{coder}.up_blocks.{lvl}.resnets.{m.group(2)}.{m.group(3)}"
        m = re.match(r"up\.(\d+)\.upsample\.conv\.(.*)", r)
        if m:
            lvl = n_levels - 1 - int(m.group(1))
            return f"{coder}.up_blocks.{lvl}.upsamplers.0.conv.{m.group(2)}"
        m = re.match(r"mid\.block_(\d)\.(.*)", r)
        if m:
            return f"{coder}.mid_block.resnets.{int(m.group(1)) - 1}.{m.group(2)}"
        m = re.match(r"mid\.attn_1\.(.*)", r)
        if m:
            attn = {"q": "to_q", "k": "to_k", "v": "to_v",
                    "proj_out": "to_out.0", "norm": "group_norm"}
            rest = m.group(1)
            for a, b in attn.items():
                if rest.startswith(a + "."):
                    return f"{coder}.mid_block.attentions.0.{b}." + rest[len(a) + 1:]
        return f"{coder}.{r}"
    return None


# ------------------------------------------------------------- CLIP names


def _split_in_proj(out: Dict[str, torch.Tensor], prefix: str, t: torch.Tensor, leaf: str):
    d = t.shape[0] // 3
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{prefix}self_attn.{name}.{leaf}"] = t[i * d:(i + 1) * d]


def openclip_text_to_hf(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """An OpenCLIP text tower (``<prefix>transformer.resblocks...``) -> HF-CLIP
    names (what ``translate_clip_name`` targets), the fused in_proj qkv split
    and ``text_projection`` transposed to [out, in]."""
    out: Dict[str, torch.Tensor] = {}
    table = {"ln_1.": "layer_norm1.", "ln_2.": "layer_norm2.", "mlp.c_fc.": "mlp.fc1.",
             "mlp.c_proj.": "mlp.fc2.", "attn.out_proj.": "self_attn.out_proj."}
    for k, t in state.items():
        if not k.startswith(prefix):
            continue
        r = k[len(prefix):]
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)", r)
        if m:
            p, rest = f"text_model.encoder.layers.{m.group(1)}.", m.group(2)
            for a, b in table.items():
                if rest.startswith(a):
                    out[p + b + rest[len(a):]] = t
                    break
            else:
                m2 = re.match(r"attn\.in_proj_(weight|bias)", rest)
                if m2:
                    _split_in_proj(out, p, torch.as_tensor(t), m2.group(1))
            continue
        if r == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = t
        elif r == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = t
        elif r.startswith("ln_final."):
            out["text_model.final_layer_norm." + r[len("ln_final."):]] = t
        elif r == "text_projection":
            out["text_projection.weight"] = torch.as_tensor(t).t().contiguous()
    return out


# ------------------------------------------------------------- the writer


def _ldm_unet_keys(cfg, prefix: str = "model.diffusion_model."):
    """Every LDM UNet key a model of ``cfg`` can have (a superset)."""
    depth = max(max(cfg.transformer_layers), 1)
    per = cfg.layers_per_block + 1
    leaves = ("weight", "bias")
    resnet = ("in_layers.0", "in_layers.2", "emb_layers.1", "out_layers.0", "out_layers.3",
              "skip_connection")
    attn = ["norm", "proj_in", "proj_out"] + [
        f"transformer_blocks.{d}.{rest}" for d in range(depth)
        for rest in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                     "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0",
                     "norm1", "norm2", "norm3", "ff.net.0.proj", "ff.net.2")]
    keys = [f"{p}.{leaf}" for p in ("time_embed.0", "time_embed.2", "label_emb.0.0",
                                    "label_emb.0.2", "input_blocks.0.0", "out.0", "out.2")
            for leaf in leaves]
    for idx in range(1, per * len(cfg.block_out_channels)):
        keys += [f"input_blocks.{idx}.0.{r}.{leaf}" for r in resnet + ("op",) for leaf in leaves]
        keys += [f"input_blocks.{idx}.1.{r}.{leaf}" for r in attn for leaf in leaves]
    for idx in range(per * len(cfg.block_out_channels)):
        keys += [f"output_blocks.{idx}.0.{r}.{leaf}" for r in resnet for leaf in leaves]
        keys += [f"output_blocks.{idx}.{sub}.{r}.{leaf}" for sub in (1, 2)
                 for r in attn + ["conv"] for leaf in leaves]
    keys += [f"middle_block.{sub}.{r}.{leaf}" for sub in (0, 2) for r in resnet
             for leaf in leaves]
    keys += [f"middle_block.1.{r}.{leaf}" for r in attn for leaf in leaves]
    return [prefix + k for k in keys]


def _ldm_vae_keys(cfg, prefix: str = "first_stage_model."):
    """Every LDM VAE key a model of ``cfg`` can have (a superset)."""
    keys = []
    for coder, blocks in (("encoder", "down"), ("decoder", "up")):
        for leaf in ("weight", "bias"):
            keys += [f"{coder}.conv_in.{leaf}", f"{coder}.conv_out.{leaf}",
                     f"{coder}.norm_out.{leaf}"]
            for i in range(len(cfg.block_out_channels)):
                for j in range(cfg.layers_per_block + 1):
                    keys += [f"{coder}.{blocks}.{i}.block.{j}.{r}.{leaf}"
                             for r in ("norm1", "conv1", "norm2", "conv2", "nin_shortcut")]
                keys += [f"{coder}.{blocks}.{i}.{blocks}sample.conv.{leaf}"]
            keys += [f"{coder}.mid.{b}.{r}.{leaf}" for b in ("block_1", "block_2")
                     for r in ("norm1", "conv1", "norm2", "conv2")]
            keys += [f"{coder}.mid.attn_1.{r}.{leaf}" for r in ("q", "k", "v", "proj_out", "norm")]
    keys += [f"{c}.{leaf}" for c in ("quant_conv", "post_quant_conv") for leaf in ("weight", "bias")]
    return [prefix + k for k in keys]


def ldm_state_dict(unet: torch.nn.Module, vae: torch.nn.Module,
                   text_model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An SD1.x single-file state dict (LDM names, CLIP-L under
    ``cond_stage_model.transformer.``, the VAE's attention linears as 1x1
    convs) of the port's modules, each tensor as the module holds it: the
    inverse of ``load_single_file`` for SD1.x."""
    rev_u, rev_v = {}, {}
    for k in _ldm_unet_keys(unet.cfg):
        dk = ldm_unet_key_to_diffusers(k, len(unet.cfg.block_out_channels),
                                       unet.cfg.layers_per_block)
        rev_u.setdefault(dk, k)
    for k in _ldm_vae_keys(vae.cfg):
        rev_v.setdefault(ldm_vae_key_to_diffusers(k, len(vae.cfg.block_out_channels)), k)
    out = {}
    for module, translate, rev in ((unet, translate_unet_name, rev_u),
                                   (vae, translate_vae_name, rev_v)):
        for name, t in module.state_dict().items():
            key = rev.get(translate(name.replace(".", "/")))
            if key is None:
                raise KeyError(f"no LDM name for {name}")
            if "attn_1" in key and key.endswith(("q.weight", "k.weight", "v.weight",
                                                 "proj_out.weight")):
                t = t[:, :, None, None]
            out[key] = t
    for name, t in text_model.state_dict().items():
        out["cond_stage_model.transformer." + translate_clip_name(name.replace(".", "/"))] = t
    return out


# ------------------------------------------------------- config detection


def detect_arch(state: Dict[str, torch.Tensor]) -> str:
    """'sd1' | 'sd2' | 'sdxl' from the checkpoint's structure."""
    if "conditioner.embedders.1.model.ln_final.weight" in state or any(
            k.startswith("conditioner.embedders.") for k in state):
        return "sdxl"
    k = "model.diffusion_model.input_blocks.4.1.transformer_blocks.0.attn2.to_k.weight"
    ctx = state[k].shape[1] if k in state else 768
    return "sd2" if ctx == 1024 else "sd1"


def _is_v_model(state) -> bool:
    """SD2.1-v carries no marker in the file (A1111 reads a .yaml beside it):
    epsilon unless the caller passes a v-prediction schedule."""
    return False


def load_single_file(path: str, dtype: Optional[torch.dtype] = None, schedule=None,
                     tokenizer_dir: Optional[str] = None, device=None, unet_config=None,
                     vae_config=None, clip_config=None):
    """(DiffusionPipeline, conditioner) from one LDM checkpoint on ``device``
    (the card unless the caller names another), weights in ``dtype`` (fp32
    by default). A single file carries no tokenizer: ``tokenizer_dir``
    (vocab.json + merges.txt) or a ``tokenizer/`` folder beside the file,
    else a hash tokenizer (fine for smoke tests, wrong for real prompts).
    ``unet_config``, ``vae_config`` and ``clip_config`` replace the configs
    the detected architecture implies (for a checkpoint of other widths)."""
    from ..pipeline import DiffusionPipeline
    from ..samplers.schedule import NoiseSchedule
    from ..text import CLIPTokenizer, SDXLConditioner, TextConditioner

    device = resolve_device(device)
    dtype = dtype or torch.float32
    state = load_safetensors(path)
    arch = detect_arch(state)
    ucfg = unet_config or {"sd1": unet_mod.sd15_unet_config, "sd2": unet_mod.sd21_unet_config,
                           "sdxl": unet_mod.sdxl_unet_config}[arch]()
    ic_key = "model.diffusion_model.input_blocks.0.0.weight"
    if ic_key in state and state[ic_key].shape[1] != ucfg.in_channels:
        ucfg = dataclasses.replace(ucfg, in_channels=state[ic_key].shape[1])

    # UNet and VAE: LDM names -> diffusers, then the folder loader's translation
    u_state, v_state = {}, {}
    for k, t in state.items():
        dk = ldm_unet_key_to_diffusers(k, len(ucfg.block_out_channels), ucfg.layers_per_block)
        if dk is not None:
            u_state[dk] = t
        dk = ldm_vae_key_to_diffusers(k)
        if dk is not None:
            v_state[dk] = t
    # SDXL's VAE scales latents by 0.13025 (SD1 and SD2: 0.18215)
    vcfg = vae_config or (vae_mod.VAEConfig(scaling_factor=0.13025) if arch == "sdxl"
                          else vae_mod.VAEConfig())

    def strip(prefix):
        return {k[len(prefix):]: t for k, t in state.items() if k.startswith(prefix)}

    if arch == "sd1":
        ccfg, c_state = clip_mod.clip_l_config(), strip("cond_stage_model.transformer.")
    elif arch == "sd2":
        ccfg = clip_mod.open_clip_h_config()
        c_state = openclip_text_to_hf(state, "cond_stage_model.model.")
    else:
        ccfg = dataclasses.replace(clip_mod.clip_l_config(), clip_skip=2, ln_penultimate=False)
        c_state = strip("conditioner.embedders.0.transformer.")
    ccfg = clip_config or ccfg
    with torch.device("meta"):
        unet = unet_mod.UNet2DCondition(ucfg, dtype=dtype,
                                        layout=unet_mod.default_unet_layout())
        vae = vae_mod.AutoencoderKL(vcfg, dtype=dtype)
        clip = clip_mod.CLIPTextModel(ccfg, dtype=dtype)
    load_module(unet, u_state, translate_unet_name, dtype, device)
    load_module(vae, v_state, translate_vae_name, dtype, device)
    load_module(clip, c_state, translate_clip_name, dtype, device, strict=(arch != "sd1"))

    if schedule is None:
        schedule = NoiseSchedule(prediction_type=(
            "v_prediction" if arch == "sd2" and _is_v_model(state) else "epsilon"))

    tok = tok2 = None
    td = tokenizer_dir or os.path.join(os.path.dirname(os.path.abspath(path)), "tokenizer")
    if os.path.exists(os.path.join(td, "vocab.json")):
        files = (os.path.join(td, "vocab.json"), os.path.join(td, "merges.txt"))
        tok = CLIPTokenizer.from_files(*files)
        tok2 = CLIPTokenizer.from_files(*files, pad_with_eot=False)
    else:
        print(f"[mdu_tpu_torch] single-file load: no tokenizer files in {td}; using a hash "
              "tokenizer (pass tokenizer_dir for real prompts)", file=sys.stderr)

    pipe = DiffusionPipeline(unet, vae, schedule, device=device)
    conditioner = TextConditioner(clip, tok, device=device)
    if arch == "sdxl":
        ccfg2 = clip_mod.open_clip_bigg_config()
        with torch.device("meta"):
            clip2 = clip_mod.CLIPTextModel(ccfg2, dtype=dtype)
        load_module(clip2, openclip_text_to_hf(state, "conditioner.embedders.1.model."),
                    translate_clip_name, dtype, device)
        conditioner = SDXLConditioner(conditioner, TextConditioner(clip2, tok2, device=device))
    return pipe, conditioner
