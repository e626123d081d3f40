"""Evaluation: the latent and image evaluator CLIs
(:mod:`~fer_vit_tpu_torch.eval.evaluate_model`,
:mod:`~fer_vit_tpu_torch.eval.evaluate_image_vit`) with the checkpoint
loaders they share (the port's own, the JAX trainers' and reference-format
torch checkpoints), the LEAM weight figure, the learning-curve and
data-fraction plots."""
