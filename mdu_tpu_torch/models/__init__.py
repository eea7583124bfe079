from .convert import load_jax_params, random_state_dict, state_dict_from_jax
from .unet import UNet2DCondition, UNetConfig, sd15_unet_config, tiny_unet_config
from .vae import (AutoencoderKL, Decoder, Encoder, VAEConfig, sample_from_moments,
                  tiny_vae_config)

__all__ = [
    "load_jax_params", "random_state_dict", "state_dict_from_jax", "UNet2DCondition",
    "UNetConfig", "sd15_unet_config", "tiny_unet_config", "AutoencoderKL", "Decoder",
    "Encoder", "VAEConfig", "sample_from_moments", "tiny_vae_config",
]
