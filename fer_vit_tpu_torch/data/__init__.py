"""Data: the image store, augmentation and normalisation, image packs,
latent production (``generate_latents`` with the native image decoder), the
latent store, latent augmentation and splits."""
