"""ctypes bindings for the repo's native C++ image codec (``native/loader.cpp``).

Counterpart of ``imagetransformations_tpu/pipeline/native_io.py``: a
multithreaded libjpeg/libpng decode + bilinear resize straight into one
NHWC uint8 batch buffer, and a multithreaded libjpeg encoder — the
replacement for the reference's ``DataLoader(num_workers=N)`` worker pools
(e.g. attacks/uncertainty/FINAL_cifar_corrupted.py:210).

The shared library is built at first use with the command of
``native/build.sh`` (g++, the system libjpeg and libpng) into the package's
gitignored ``_build/`` directory, keyed by a hash of the source and the
flags; nothing is written into ``native/``. Where it cannot be built (no
g++, no codec headers), every entry point falls back to PIL; where PIL is
missing too, the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: native/build.sh's command, less its output path
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_build_error: str | None = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libittloader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _get_lib():
    """The loaded library, built first if needed; None (and the reason in
    ``build_error()``) where it cannot be built or loaded."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.itt_decode_batch.restype = ctypes.c_int
        lib.itt_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.itt_encode_batch.restype = ctypes.c_int
        lib.itt_encode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def build_error() -> str | None:
    """Why the native library is unavailable (None if it loaded or was not
    tried yet)."""
    return _build_error


def _paths_arg(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def decode_batch(paths: list[str], size: tuple[int, int], n_threads: int = 4) -> np.ndarray:
    """Decode + resize a list of image files -> NHWC uint8 [N, H, W, 3].

    size = (width, height) to match PIL's resize convention. The native
    resize is point-sampled bilinear (cv2 INTER_LINEAR); the PIL fallback
    resizes with PIL's bilinear filter.
    """
    w, h = size
    out = np.empty((len(paths), h, w, 3), np.uint8)
    lib = _get_lib()
    if lib is None:
        from PIL import Image

        for i, p in enumerate(paths):
            out[i] = np.asarray(Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR),
                                np.uint8)
        return out
    failures = lib.itt_decode_batch(_paths_arg(paths), len(paths),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                                    n_threads)
    if failures:
        raise IOError(f"native loader failed to decode {failures} of {len(paths)} files")
    return out


def encode_batch(images: np.ndarray, paths: list[str], quality: int = 75,
                 n_threads: int = 4) -> None:
    """JPEG-encode an NHWC uint8 batch to per-image file paths.

    Multithreaded libjpeg (quality default 75 = PIL's default); PIL where
    the native library is unavailable.
    """
    images = np.ascontiguousarray(np.asarray(images, np.uint8))
    n, h, w, c = images.shape
    if c != 3 or len(paths) != n:
        raise ValueError(f"expected {len(paths)} RGB images, got shape {images.shape}")
    lib = _get_lib()
    if lib is None:
        from PIL import Image

        for img, p in zip(images, paths):
            Image.fromarray(img).save(p, quality=quality)
        return
    failures = lib.itt_encode_batch(_paths_arg(paths), n,
                                    images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    h, w, quality, n_threads)
    if failures:
        raise IOError(f"native encoder failed on {failures} of {n} files")


def load_folder_images_native(root: str, size: tuple[int, int],
                              n_threads: int = 4) -> tuple[np.ndarray, list[str]]:
    """Native-decode an image folder -> (NHWC uint8 batch, paths)."""
    from imagetransformations_tpu_torch.pipeline.io import walk_image_files

    paths = walk_image_files(root)
    if not paths:
        return np.zeros((0, size[1], size[0], 3), np.uint8), []
    return decode_batch(paths, size, n_threads), paths
