"""Pixel-space BBDM: the Brownian bridge, its ADM denoiser with NAS cells,
and the EMA of its weights."""
