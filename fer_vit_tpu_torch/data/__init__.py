"""Data: the image route's eval normalisation, latent production
(``generate_latents`` with the native image decoder), the latent store, latent
augmentation and splits."""
