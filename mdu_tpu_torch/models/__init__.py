from .clip import (CLIPTextConfig, CLIPTextModel, clip_l_config, open_clip_bigg_config,
                   open_clip_h_config, tiny_clip_config)
from .controlnet import ControlNet, ControlNetConditioningEmbedding
from .convert import load_jax_params, random_state_dict, state_dict_from_jax
from .esrgan import (RRDBNet, RRDBNetConfig, load_esrgan, register_esrgan_upscaler,
                     tiny_rrdb_config)
from .stablesr import StableSRGuidance, combine_residuals
from .unet import (UNet2DCondition, UNetConfig, default_unet_layout, sd15_unet_config,
                   sd21_unclip_unet_config, sd21_unet_config, sdxl_unet_config,
                   tiny_sdxl_unet_config, tiny_unet_config)
from .vae import (AutoencoderKL, Decoder, Encoder, VAEConfig, sample_from_moments,
                  tiny_vae_config)

__all__ = [
    "CLIPTextConfig", "CLIPTextModel", "clip_l_config", "open_clip_bigg_config",
    "open_clip_h_config", "tiny_clip_config",
    "ControlNet", "ControlNetConditioningEmbedding", "load_jax_params", "random_state_dict",
    "state_dict_from_jax", "RRDBNet", "RRDBNetConfig", "load_esrgan",
    "register_esrgan_upscaler", "tiny_rrdb_config", "StableSRGuidance", "combine_residuals",
    "UNet2DCondition", "UNetConfig", "default_unet_layout", "sd15_unet_config",
    "sd21_unclip_unet_config",
    "sd21_unet_config", "sdxl_unet_config", "tiny_sdxl_unet_config", "tiny_unet_config",
    "AutoencoderKL", "Decoder", "Encoder", "VAEConfig", "sample_from_moments",
    "tiny_vae_config",
]
