"""CLI alias: the AFS style-extractor trainer lives in
:mod:`fer_vit_tpu_torch.afs.train_style_extractor`; this module mirrors the
reference's ``train/train_style_extractor.py`` location::

    python -m fer_vit_tpu_torch.train.train_style_extractor --latent_dir ...
"""

from fer_vit_tpu_torch.afs.train_style_extractor import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    main(build_parser().parse_args())
