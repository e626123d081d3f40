"""Evaluation: the latent and image evaluator CLIs
(:mod:`~fer_vit_tpu_torch.eval.evaluate_model`,
:mod:`~fer_vit_tpu_torch.eval.evaluate_image_vit`), which load checkpoints
through :mod:`fer_vit_tpu_torch.interop.checkpoints`, the LEAM weight
figure, the learning-curve and data-fraction plots."""
