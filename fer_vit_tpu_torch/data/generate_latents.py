"""Generate pSp w+ latents from a class-structured image directory.

Port of ``fer_vit_tpu/data/generate_latents.py``, with the same CLI
(reference: data/generate_latents.py:164-172: ``--data_root --latent_out
--encoder_model --encoder_type --batch_size``) and the same files:

* a background thread decodes images (the native decoder, else PIL) into
  padded batches while the card encodes the previous one;
* the pSp encoder (:class:`fer_vit_tpu_torch.encoders.psp.EncoderWrapper`,
  BN folded, every trunk unit through the fused IR-SE kernel, bf16 on CUDA)
  runs at a large fixed batch (default 256, the last batch padded);
* outputs are sharded ``.npz`` packs (``latents_pack_XXXX.npz`` with
  latents/labels/paths) that :class:`fer_vit_tpu_torch.data.latent_store
  .LatentStore` reads; ``--per_image_pt`` also writes reference-format
  per-image ``{cls}_{base}.pt`` files;
* resumable: ``manifest.json`` records the images whose pack is on disk,
  and a re-run skips them;
* ``--num_shards/--shard_id`` (default: the ``torch.distributed`` world
  size and rank when a process group is initialised, else 1/0)
  round-robin-partition the sorted image list across workers; each writes
  packs ``latents_pack_w{id}_XXXX.npz`` and its own manifest, so workers
  sharing one output directory never collide.

``generate_latents(..., device=None)`` runs on CUDA and raises without it
unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_TO_INDEX
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import IMAGE_EXTS

SHARD_SIZE = 4096


def _class_of(path: str) -> str:
    """Class-dir name of an image path: the reference prefixes per-image
    latent files with it (`{cls}_{base}.pt`, reference :137), which also
    keeps same-named files of different class dirs apart."""
    return os.path.basename(os.path.dirname(path))


def collect_images(data_root: str) -> List[Tuple[str, int]]:
    """Walk class subdirs -> [(image_path, label)] (reference :114-151)."""
    items: List[Tuple[str, int]] = []
    for cls_name, label in sorted(EMOTION_TO_INDEX.items(), key=lambda kv: kv[1]):
        cls_dir = os.path.join(data_root, cls_name)
        if not os.path.isdir(cls_dir):
            continue
        for fname in sorted(os.listdir(cls_dir)):
            if fname.lower().endswith(IMAGE_EXTS):
                items.append((os.path.join(cls_dir, fname), label))
    if not items:
        raise ValueError(f"No class-dir images found under {data_root}")
    return items


def _load_image(path: str, size: int = 256) -> np.ndarray:
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert("RGB").resize((size, size), Image.BILINEAR)
            return np.asarray(im, dtype=np.float32)
    except Exception:
        # corrupt file -> black image (reference data/image_dataset.py:125-130)
        return np.zeros((size, size, 3), np.float32)


def _decode_batches(
    items: Sequence[Tuple[str, int]], batch_size: int, size: int,
    prefetch: int = 2,
) -> Iterator[Tuple[np.ndarray, np.ndarray, List[str], int]]:
    """Background-thread decoder yielding padded (images, labels, paths, n):
    images f32 0-255 (batch_size, size, size, 3)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    from fer_vit_tpu_torch.data import native_decode

    use_native = native_decode.available()

    def worker():
        for i in range(0, len(items), batch_size):
            chunk = items[i : i + batch_size]
            if use_native:
                # C++ thread-pool decode of the whole batch in one call
                imgs = native_decode.decode_batch(
                    [p for p, _ in chunk], size).astype(np.float32)
            else:
                imgs = np.stack([_load_image(p, size) for p, _ in chunk])
            labels = np.asarray([l for _, l in chunk], np.int32)
            n = len(chunk)
            if n < batch_size:  # pad to the fixed batch shape
                pad = batch_size - n
                imgs = np.concatenate([imgs, np.zeros((pad, size, size, 3),
                                                      np.float32)])
                labels = np.concatenate([labels, np.zeros(pad, np.int32)])
            q.put((imgs, labels, [p for p, _ in chunk], n))
        q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item


class ShardWriter:
    def __init__(self, out_dir: str, shard_size: int = SHARD_SIZE,
                 start_index: int = 0, prefix: str = "latents_pack"):
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.shard_index = start_index
        self.prefix = prefix
        self._lat: List[np.ndarray] = []
        self._lab: List[int] = []
        self._paths: List[str] = []

    def add(self, latents: np.ndarray, labels: np.ndarray,
            paths: List[str]) -> List[str]:
        """Buffer a batch; returns the paths made durable by a shard flush
        in this call ([] while the buffer fills). The resume manifest must
        record only durable paths: marking buffered samples processed would
        lose them on a crash."""
        self._lat.append(latents)
        self._lab.extend(labels.tolist())
        self._paths.extend(paths)
        if len(self._paths) >= self.shard_size:
            return self.flush()
        return []

    def flush(self) -> List[str]:
        if not self._paths:
            return []
        lat = np.concatenate(self._lat)[: len(self._paths)]
        path = os.path.join(self.out_dir,
                            f"{self.prefix}_{self.shard_index:04d}.npz")
        np.savez(path, latents=lat.astype(np.float32),
                 labels=np.asarray(self._lab, np.int32),
                 paths=np.asarray(self._paths))
        print(f"wrote {path} ({len(self._paths)} samples)")
        self.shard_index += 1
        written = self._paths
        self._lat, self._lab, self._paths = [], [], []
        return written


def resolve_worker_shard(num_shards: Optional[int],
                         shard_id: Optional[int]) -> Tuple[int, int]:
    """(num_shards, shard_id) of this worker. ``num_shards in (None, 0)``:
    the ``torch.distributed`` world size (and rank, for an auto id) when a
    process group is initialised, else 1 (and 0). Explicit values win."""
    if num_shards in (None, 0):
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        num_shards = dist.get_world_size() if up else 1
        if shard_id in (None, -1):
            shard_id = dist.get_rank() if up else 0
    elif shard_id in (None, -1):
        shard_id = 0
    if not 0 <= shard_id < num_shards:
        raise ValueError(
            f"shard_id {shard_id} out of range for num_shards {num_shards}")
    return num_shards, shard_id


def load_encoder(encoder_model: Optional[str], device: torch.device,
                 dtype: Optional[torch.dtype] = None):
    """The pSp encoder from a converted ``.npz`` (the JAX package's
    ``convert_psp.py`` output) or a pSp ``.pt`` checkpoint, in ``dtype``
    compute (None: bf16 on CUDA, f32 on the CPU)."""
    from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper,
                                                psp_state_dict_from_checkpoint)

    if not (encoder_model and os.path.exists(encoder_model)):
        raise FileNotFoundError(
            f"encoder checkpoint not found: {encoder_model!r} "
            "(pass a converted .npz or a pSp .pt)")
    if encoder_model.endswith(".npz"):
        return EncoderWrapper.from_npz(encoder_model, dtype=dtype,
                                       device=device)
    return EncoderWrapper(psp_state_dict_from_checkpoint(encoder_model),
                          dtype=dtype, device=device)


def _host(w) -> np.ndarray:
    return w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)


def generate_latents(
    data_root: str,
    latent_out: str,
    encoder_model: Optional[str] = None,
    batch_size: int = 256,
    per_image_pt: bool = False,
    encoder=None,
    shard_size: int = SHARD_SIZE,
    num_shards: Optional[int] = 1,
    shard_id: Optional[int] = 0,
    device: DeviceLike = None,
) -> int:
    """Run the pipeline; returns the number of newly encoded images.
    ``encoder`` (anything with ``encode_batch``) replaces loading
    ``encoder_model``."""
    device = resolve_device(device)
    num_shards, shard_id = resolve_worker_shard(num_shards, shard_id)
    # per-worker namespaces: the global image list is deterministic (sorted
    # class walk), so a round-robin partition is stable across runs
    if num_shards > 1:
        pack_prefix = f"latents_pack_w{shard_id:02d}"
        manifest_name = f"manifest_w{shard_id:02d}_of_{num_shards:02d}.json"
    else:
        pack_prefix = "latents_pack"
        manifest_name = "manifest.json"

    os.makedirs(latent_out, exist_ok=True)
    manifest_path = os.path.join(latent_out, manifest_name)
    done = set()
    start_shard = 0
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        done = set(manifest.get("processed", []))
        start_shard = manifest.get("next_shard", 0)

    all_items = collect_images(data_root)
    mine = [it for k, it in enumerate(all_items) if k % num_shards == shard_id]
    items = [it for it in mine if it[0] not in done]
    if num_shards > 1:
        print(f"worker {shard_id}/{num_shards}: "
              f"{len(mine)} of {len(all_items)} images in partition")
    print(f"{len(done)} already processed; {len(items)} to encode")
    if not items:
        return 0

    if encoder is None:
        encoder = load_encoder(encoder_model, device)

    def write_manifest():
        # atomic replace: a crash mid-write must not truncate the manifest
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"processed": sorted(done),
                       "next_shard": writer.shard_index}, f)
        os.replace(tmp, manifest_path)

    writer = ShardWriter(latent_out, shard_size=shard_size,
                         start_index=start_shard, prefix=pack_prefix)
    n_done = 0
    for imgs, labels, paths, n in _decode_batches(items, batch_size, 256):
        w_plus = _host(encoder.encode_batch(imgs))[:n]
        # only shard-flushed samples are durable; buffered ones must not
        # enter the manifest (a crash would skip them forever on resume;
        # still-buffered samples re-encode next run, and the per-image .pt
        # writes below are idempotent)
        flushed = writer.add(w_plus, labels[:n], paths)
        if per_image_pt:
            for j, p in enumerate(paths):
                out_name = (_class_of(p) + "_"
                            + os.path.splitext(os.path.basename(p))[0]
                            + ".pt")
                torch.save(
                    {"latent": torch.tensor(w_plus[j]),
                     "label": int(labels[j]), "img_path": p},
                    os.path.join(latent_out, out_name),
                )
        n_done += n
        if flushed:
            done.update(flushed)
            write_manifest()
    done.update(writer.flush())
    write_manifest()
    print(f"encoded {n_done} images → {latent_out}")
    return n_done


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate pSp w+ latents from images"
    )
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--latent_out", required=True)
    parser.add_argument("--encoder_model", required=True,
                        help="converted .npz (preferred) or pSp .pt checkpoint")
    parser.add_argument("--encoder_type", choices=["psp", "e4e"],
                        default="psp")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--per_image_pt", action="store_true",
                        help="also write reference-format per-image .pt files")
    parser.add_argument("--num_shards", type=int, default=0,
                        help="partition the image list over this many "
                             "workers (0 = auto from torch.distributed's "
                             "world size; 1 = single-worker)")
    parser.add_argument("--shard_id", type=int, default=-1,
                        help="this worker's partition index "
                             "(-1 = auto: torch.distributed's rank)")
    return parser


def main(args, device: DeviceLike = None) -> int:
    if args.encoder_type != "psp":
        raise NotImplementedError(
            "e4e is stubbed in the reference too (encoder_wrapper.py:97-133)"
        )
    return generate_latents(
        args.data_root, args.latent_out, args.encoder_model,
        args.batch_size, args.per_image_pt,
        num_shards=args.num_shards, shard_id=args.shard_id, device=device,
    )


if __name__ == "__main__":
    main(build_parser().parse_args())
