"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` inside the
package, compiled for Hopper (``sm_90a``) without FMA contraction. The hash
covers every file in ``csrc/`` and the compiler flags, so an edited source
builds anew and an unchanged one is reused. Nothing is built at import:
the first :func:`load` builds every missing library, all ``nvcc`` processes
started together. A failed build raises.

Each library exports C entry points (one named like the library;
``shear_rows`` also ``shear_cols``, ``rotate_nearest`` also
``rotate_nearest_float``) that take every pointer and the stream
as ``void*`` and return a CUDA error code (0 on success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels must round every add and multiply on
    # its own to stay bit-exact against the oracle and the plain versions
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points of each library, by the library's name (its source file):
#: {entry point: argtypes}
SIGNATURES = {
    # x, s1 (the f32 plane between the launches), out, taps, p, k1, f1, k2,
    # f2, stride_h, stride_w, n, h, w, fill, rows_a, rows_b, seg_w, win,
    # threads, groups, stream
    "luma_blur_rotate": {"luma_blur_rotate": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)},
    # x, out, taps, p, k1, f1, k2, f2, stride_h, stride_w, n, h, w, c, fill,
    # strict, grayscale, identity, identity_stride, tile_rows_log2,
    # tile_cols_log2, chunk_rows, max_r1, max_c2, max_c1, smem_bytes, batch, stream
    "rgb_blur_rotate": {"rgb_blur_rotate": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _I, _P, _I,
                                            _I, _I, _I, _I, _I, _I, _I, _I, _P)},
    # x, out, factors, n, h, w, c, stream
    "shear_bicubic": {"shear_bicubic": (_P, _P, _P, _I, _I, _I, _I, _P)},
    # shear_rows: x, out, shifts, shift_stride, n, h, w, c, fill, b_px,
    # grayscale, stream; shear_cols: x, out, shifts, n, h, w, c, fill, b_px,
    # stream
    "shear_rows": {"shear_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
                   "shear_cols": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
    # x, out, factors, n, h, w, c, stream
    "zoom_bilinear": {"zoom_bilinear": (_P, _P, _P, _I, _I, _I, _I, _P)},
    # rotate_nearest: x, out, coeffs, coeff_stride, n, h, w, c, fill, stream;
    # rotate_nearest_float: x, out, images, rows, steps, m, h, w, c, fill,
    # stream
    "rotate_nearest": {"rotate_nearest": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
                       "rotate_nearest_float": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)},
    # x, out, taps, tap_stride, tap_width, n, h, w, c, stream
    "blur_separable": {"blur_separable": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
}

#: kernel launches, by kernel: each wrapper call that launches its CUDA
#: kernel (or kernel pair) adds one. One dict for every wrapper module;
#: ``megakernel.LAUNCHES`` is the same object. The luma kernel counts under
#: "luma_blur_rotate_packed" below 128 rows (whole images, several a block), and the
#: blur-rotate kernels under "*_traced" when their shifts are per image
#: (the counterparts of the per-image-angle Pallas kernels). The library
#: shear_rows counts under the Pallas entry point it carries:
#: "shear_rows_logrouted", "shear_rows" (one shift vector for the batch) or
#: "shear_rows_per_image"; its column pass (rotate_3shear's middle pass)
#: under "shear_cols" and, as the pass of "shear_rows" it carries, there
#: too; rotate_nearest counts as "pil_rotate_nearest";
#: blur_separable as "blur_separable" (one radius, from blur_separable and
#: blur_to_sheared_rows) or "blur_separable_batched" (one radius an image).
LAUNCHES = {
    "luma_blur_rotate": 0, "luma_blur_rotate_packed": 0, "rgb_blur_rotate": 0,
    "luma_blur_rotate_traced": 0, "rgb_blur_rotate_traced": 0, "shear_bicubic": 0,
    "shear_rows_logrouted": 0, "zoom_bilinear": 0, "pil_rotate_nearest": 0,
    "blur_separable": 0, "shear_rows": 0, "shear_rows_per_image": 0,
    "blur_separable_batched": 0, "shear_cols": 0,
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all() -> dict[str, str]:
    """Compile every library that is not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the libraries built by this call
    (registers, shared memory and spills of each kernel). Raises
    RuntimeError with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
