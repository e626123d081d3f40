"""Pre-decoded uint8 image packs: the serving input path without JPEG/PNG
decoding.

Port of ``fer_vit_tpu/data/image_packs.py``, with the same files, so that a
pack written by either package reads in the other::

    out_dir/
      images_pack_0000.npy   (N, S, S, 3) uint8 (np.save format)
      images_pack_0001.npy   ...
      manifest.json          {"size", "num_images", "shards": [{"file",
                              "n"}...], "paths", "labels"|null,
                              "decode_ok"}

Images decode once (the native decoder where it builds, PIL otherwise);
a file that fails to decode is black-filled and flagged ``false`` in
``decode_ok``. Shards are read back with ``np.load(mmap_mode="r")`` by a
background thread that assembles the next padded batch while the caller's
device call runs.

Usage (``python -m fer_vit_tpu_torch.serve --packed`` reads the result)::

    python -m fer_vit_tpu_torch.data.image_packs --input faces/ \
        --output packs/faces_256 --size 256
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST = "manifest.json"
SHARD_FMT = "images_pack_{:04d}.npy"
DEFAULT_SHARD_SIZE = 4096


class _PackWriter:
    """Writes uint8 (n, S, S, 3) blocks as shards of ``shard_size`` images
    and, on :meth:`finish`, the manifest."""

    def __init__(self, out_dir: str, size: int, shard_size: int):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.size, self.shard_size = out_dir, size, shard_size
        self.shards: List[dict] = []
        self.decode_ok: List[bool] = []
        self._buf: List[np.ndarray] = []
        self._buffered = 0

    def _flush(self) -> None:
        if not self._buffered:
            return
        arr = (np.concatenate(self._buf) if len(self._buf) > 1
               else self._buf[0])
        fname = SHARD_FMT.format(len(self.shards))
        np.save(os.path.join(self.out_dir, fname), arr)
        self.shards.append({"file": fname, "n": int(len(arr))})
        self._buf, self._buffered = [], 0

    def add(self, imgs: np.ndarray, ok: Sequence[bool]) -> None:
        self.decode_ok.extend(bool(v) for v in ok)
        self._buf.append(imgs)
        self._buffered += len(imgs)
        while self._buffered >= self.shard_size:
            whole = (np.concatenate(self._buf) if len(self._buf) > 1
                     else self._buf[0])
            head, rest = whole[:self.shard_size], whole[self.shard_size:]
            self._buf, self._buffered = [head], self.shard_size
            self._flush()
            if len(rest):
                self._buf, self._buffered = [rest], len(rest)

    def finish(self, paths: Sequence[str],
               labels: Optional[Sequence[int]]) -> dict:
        self._flush()
        manifest = {
            "size": int(self.size),
            "num_images": len(paths),
            "shards": self.shards,
            "paths": list(paths),
            "labels": (None if labels is None else [int(l) for l in labels]),
            "decode_ok": self.decode_ok,
        }
        with open(os.path.join(self.out_dir, MANIFEST), "w") as f:
            json.dump(manifest, f)
        return manifest


def _check_labels(paths, labels) -> None:
    if labels is not None and len(labels) != len(paths):
        raise ValueError(
            f"labels ({len(labels)}) must match paths ({len(paths)})")


def write_image_pack(paths: Sequence[str], out_dir: str, size: int = 256,
                     labels: Optional[Sequence[int]] = None,
                     shard_size: int = DEFAULT_SHARD_SIZE,
                     decode_batch_size: int = 256) -> dict:
    """Decode ``paths`` at ``size`` and write uint8 shards and the manifest
    to ``out_dir``. Returns the manifest."""
    from fer_vit_tpu_torch.data import native_decode
    from fer_vit_tpu_torch.data.generate_latents import _load_image

    _check_labels(paths, labels)
    writer = _PackWriter(out_dir, size, shard_size)
    use_native = native_decode.available()
    for i in range(0, len(paths), decode_batch_size):
        chunk = list(paths[i:i + decode_batch_size])
        if use_native:
            imgs = native_decode.decode_batch(chunk, size)
        else:
            imgs = np.stack([_load_image(p, size) for p in chunk]).astype(
                np.uint8)
        writer.add(imgs, imgs.reshape(len(chunk), -1).any(axis=1))
    return writer.finish(paths, labels)


def write_array_pack(images: np.ndarray, out_dir: str, paths: Sequence[str],
                     decode_ok: Optional[Sequence[bool]] = None,
                     labels: Optional[Sequence[int]] = None,
                     shard_size: int = DEFAULT_SHARD_SIZE) -> dict:
    """Write (N, S, S, 3) uint8 ``images`` already in memory (the
    reconstruction CLI's answers) as a pack under ``out_dir``, one
    ``paths`` entry an image, with ``decode_ok`` (all true when None).
    Returns the manifest."""
    images = np.asarray(images)
    if (images.ndim != 4 or images.shape[1] != images.shape[2]
            or images.shape[3] != 3 or images.dtype != np.uint8):
        raise ValueError(f"expected uint8 (N, S, S, 3) images, got "
                         f"{images.dtype} {images.shape}")
    if len(paths) != len(images):
        raise ValueError(
            f"paths ({len(paths)}) must match images ({len(images)})")
    _check_labels(paths, labels)
    writer = _PackWriter(out_dir, images.shape[1], shard_size)
    for i in range(0, len(images), shard_size):
        block = images[i:i + shard_size]
        writer.add(block, [True] * len(block) if decode_ok is None
                   else decode_ok[i:i + shard_size])
    return writer.finish(paths, labels)


def read_manifest(pack_dir: str) -> dict:
    path = os.path.join(pack_dir, MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {MANIFEST} under {pack_dir!r}: not an image pack "
            f"(create one with python -m fer_vit_tpu_torch.data.image_packs)")
    with open(path) as f:
        manifest = json.load(f)
    total = sum(s["n"] for s in manifest["shards"])
    if total != manifest["num_images"]:
        raise ValueError(
            f"corrupt pack: shards hold {total} images, manifest says "
            f"{manifest['num_images']}")
    return manifest


def iter_packed_batches(pack_dir: str, batch_size: int,
                        prefetch: int = 2,
                        ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield ``(images, n_valid)`` uint8 batches padded with zeros to
    ``batch_size``; a background thread assembles the next batch (mmap
    shard reads and one contiguous copy) while the caller runs."""
    manifest = read_manifest(pack_dir)
    size = manifest["size"]
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def worker() -> None:
        arrs = [np.load(os.path.join(pack_dir, s["file"]), mmap_mode="r")
                for s in manifest["shards"]]
        batch = np.empty((batch_size, size, size, 3), np.uint8)
        filled = 0
        for arr in arrs:
            pos = 0
            while pos < len(arr):
                take = min(batch_size - filled, len(arr) - pos)
                batch[filled:filled + take] = arr[pos:pos + take]
                filled += take
                pos += take
                if filled == batch_size:
                    q.put((batch, batch_size))
                    batch = np.empty((batch_size, size, size, 3), np.uint8)
                    filled = 0
        if filled:
            batch[filled:] = 0  # pad to the fixed batch shape
            q.put((batch, filled))
        q.put(None)

    t = threading.Thread(target=worker, daemon=True,
                         name="fervit-pack-reader")
    t.start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Pre-decode images into uint8 packs (the JPEG-free "
                    "serving input path for python -m "
                    "fer_vit_tpu_torch.serve --packed)")
    p.add_argument("--input", required=True, nargs="+",
                   help="image files and/or directories (recursive)")
    p.add_argument("--output", required=True,
                   help="pack directory to create")
    p.add_argument("--size", type=int, default=256,
                   help="decode resolution (must match the serving "
                        "encoder's input size; pSp = 256)")
    p.add_argument("--shard_size", type=int, default=DEFAULT_SHARD_SIZE)
    return p


def main(args) -> dict:
    from fer_vit_tpu_torch.data.image_pipeline import collect_inputs

    paths = collect_inputs(args.input)
    if not paths:
        raise SystemExit("no images found under --input")
    manifest = write_image_pack(paths, args.output, size=args.size,
                                shard_size=args.shard_size)
    n_bad = sum(1 for ok in manifest["decode_ok"] if not ok)
    print(f"packed {manifest['num_images']} images "
          f"({len(manifest['shards'])} shard(s), size {args.size}) -> "
          f"{args.output}" + (f"; {n_bad} decode failure(s) black-filled"
                              if n_bad else ""))
    return manifest


if __name__ == "__main__":
    main(build_parser().parse_args())
