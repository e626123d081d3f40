"""ctypes bindings for the native batch image decoder
(``fer_vit_tpu_torch/native_src/decode.cpp``, the port's copy of the JAX
package's source).

Port of ``fer_vit_tpu/data/native_decode.py``. Host-side image decoding, as
in the reference: a C++ thread pool over libjpeg/libpng with PIL-compatible
triangle resampling, so that feeding the card does not wait on Python. It is
built with g++ at first use into ``build/fer_vit_tpu_torch/`` at the
repository root (the file name carries a hash of the source);
:func:`available` gates every call site, which decodes with PIL when the
toolchain or the image libraries are missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from fer_vit_tpu_torch.ops._build import BUILD_DIR

# Formats decode.cpp recognizes (by magic bytes). Anything else in a batch
# (.bmp/.webp are admitted by IMAGE_EXTS) is decoded by PIL inside
# decode_batch, not black-filled by the native failure path.
NATIVE_EXTS = (".jpg", ".jpeg", ".png")

_SRC = Path(__file__).resolve().parent.parent / "native_src" / "decode.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libfervit_decode_{tag}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per-process temp name: concurrent first-use builds must not
        # clobber each other's partly written output before the publish
        fd, tmp_path = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", tmp_path, str(_SRC), "-ljpeg", "-lpng", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
            os.replace(tmp_path, so_path)
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.fervit_decode_batch.restype = ctypes.c_int
    lib.fervit_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _build_and_load()
            _tried = True
    return _lib


def available() -> bool:
    """True if the native decoder built and loaded (g++ + libjpeg/libpng)."""
    return _get_lib() is not None


def _pil_decode_into(out: np.ndarray, paths: List[str],
                     idx: List[int], size: int) -> int:
    """PIL-decode ``paths[i] for i in idx`` into ``out`` rows (convert ->
    BILINEAR resize, as the PIL call sites; corrupt files stay black).
    Returns the number of failed decodes."""
    from PIL import Image

    failures = 0
    for i in idx:
        try:
            with Image.open(paths[i]) as im:
                im = im.convert("RGB").resize((size, size), Image.BILINEAR)
                out[i] = np.asarray(im, np.uint8)
        except Exception:
            failures += 1
    return failures


def decode_batch(paths: List[str], size: int,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """Decode ``paths`` -> (N, size, size, 3) uint8; corrupt files black.

    JPEG/PNG go through the native thread pool; formats the C++ decoder
    does not recognize (.bmp/.webp) go to PIL within the same call. Native
    failures are re-decoded by PIL, so only files both reject stay black;
    failures are reported to stderr.

    Raises RuntimeError if the native library is unavailable: call sites
    check :func:`available` and decode with PIL.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    if n == 0:
        return out
    native_idx = [i for i, p in enumerate(paths)
                  if p.lower().endswith(NATIVE_EXTS)]
    threads = n_threads or min(os.cpu_count() or 1, 16)
    failures = 0
    if native_idx:
        sub = [paths[i] for i in native_idx]
        tmp = out if len(sub) == n else np.zeros((len(sub), size, size, 3),
                                                 np.uint8)
        arr = (ctypes.c_char_p * len(sub))(*[p.encode() for p in sub])
        failures = lib.fervit_decode_batch(
            arr, len(sub), tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            size, size, threads,
        )
        if tmp is not out:
            out[native_idx] = tmp
    if failures:
        # the native ABI reports a failure count, not which files; some
        # failures are content PIL handles (CMYK JPEGs, WebP bytes behind a
        # .jpg name), so the whole native subset is re-decoded with PIL
        failures = _pil_decode_into(out, paths, native_idx, size)
    other_idx = sorted(set(range(n)) - set(native_idx))
    pil_failures = 0
    if other_idx:
        pil_failures = _pil_decode_into(out, paths, other_idx, size)
    if failures or pil_failures:
        print(f"decode: {failures}/{len(native_idx)} native(+PIL-retry) + "
              f"{pil_failures}/{len(other_idx)} PIL files failed "
              "(black-image fallback)", file=sys.stderr)
    return out
