from .convert import (VAE_ENCODER_PREFIXES, load_jax_params, random_state_dict,
                      state_dict_from_jax)
from .unet import UNet2DCondition, UNetConfig, sd15_unet_config, tiny_unet_config
from .vae import AutoencoderKL, Decoder, VAEConfig, tiny_vae_config

__all__ = [
    "VAE_ENCODER_PREFIXES", "load_jax_params", "random_state_dict",
    "state_dict_from_jax", "UNet2DCondition", "UNetConfig", "sd15_unet_config",
    "tiny_unet_config", "AutoencoderKL", "Decoder", "VAEConfig", "tiny_vae_config",
]
