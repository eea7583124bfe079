"""Noise schedule, denoiser wrappers and the Euler / DDIM samplers."""
