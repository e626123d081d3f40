"""Evaluation: the checkpoint loaders (``evaluate_model.load_model`` and the
image evaluator's ``load_model``). The evaluator CLIs are not ported yet."""
