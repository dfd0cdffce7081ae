"""Native (C++) augmentation kernels: build, load, and ctypes wrappers.

`augment.cpp` re-implements the Pillow operations used by the RandAugment
policy (data/augment.py) as single-pass LUT / fused loops over whole uint8
[F, H, W, 3] clips — byte-exact vs the PIL path (tests/test_native_augment.py)
at a fraction of the per-core cost (measured A/B at 12f @ 224: 19.3 vs 51.3
ms/clip/core policy-level; see docs/SCALING.md "Host data pipeline").

Build story: no pybind11 in this environment, so the library is a plain
C ABI `.so` compiled with g++ on first use into a per-source-hash cache dir
(the repository's git-ignored `build/native/`, or `$NRTPU_NATIVE_CACHE`), loaded via
ctypes.  No `-march=native`: the cached library may be loaded on a host
with another CPU than the one that built it, where ISA-specific code would
SIGILL.  If no C++ compiler is available the loader reports unavailable
and callers fall back to the PIL path.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "augment.cpp")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _cache_dir(src_hash: str) -> str:
    # `or` (not a .get default): a set-but-empty NRTPU_NATIVE_CACHE must
    # fall back too, not become a CWD-relative path
    root = os.environ.get("NRTPU_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
        "native")
    return os.path.join(root, src_hash)


def _build(src_hash: str) -> str:
    """Compile augment.cpp -> cached .so; returns the .so path."""
    out_dir = _cache_dir(src_hash)
    so_path = os.path.join(out_dir, "libnraugment.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           "-fno-math-errno", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)  # atomic: concurrent compiles all win
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return so_path


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    f32 = ctypes.c_float
    f64 = ctypes.c_double
    lib.nr_abi_version.restype = i32
    lib.nr_invert.argtypes = [u8p, i64]
    lib.nr_posterize.argtypes = [u8p, i64, i32]
    lib.nr_solarize.argtypes = [u8p, i64, i32]
    lib.nr_solarize_add.argtypes = [u8p, i64, i32]
    lib.nr_brightness.argtypes = [u8p, i64, f32]
    lib.nr_autocontrast.argtypes = [u8p, i32, i32, i32]
    lib.nr_equalize.argtypes = [u8p, i32, i32, i32]
    lib.nr_contrast.argtypes = [u8p, i32, i32, i32, f32]
    lib.nr_color.argtypes = [u8p, i32, i32, i32, f32]
    lib.nr_sharpness.argtypes = [u8p, u8p, i32, i32, i32, f32]
    lib.nr_affine_bilinear.argtypes = [u8p, u8p, i32, i32, i32,
                                       f64, f64, f64, f64, f64, f64]


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
            lib = ctypes.CDLL(_build(src_hash))
            _declare(lib)
            got = lib.nr_abi_version()
            if got != _ABI_VERSION:
                raise RuntimeError(f"ABI {got} != expected {_ABI_VERSION}")
            _lib = lib
        except Exception as exc:  # compiler missing, build failure, ...
            _load_error = f"{type(exc).__name__}: {exc}"
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    get_lib()
    return _load_error


# ---------------------------------------------------------------------------
# Wrappers: uint8 [F, H, W, 3] C-contiguous clips (a single [H, W, 3] frame
# is promoted).  In-place ops mutate and return `clip`; sharpness/affine
# return a fresh array.
# ---------------------------------------------------------------------------

def _prep(clip: np.ndarray) -> np.ndarray:
    if clip.ndim == 3:
        clip = clip[None]
    assert clip.ndim == 4 and clip.shape[-1] == 3 and clip.dtype == np.uint8, (
        clip.shape, clip.dtype)
    return np.ascontiguousarray(clip)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"native augment backend unavailable: {_load_error}")
    return lib


def invert(clip):
    clip = _prep(clip)
    _require_lib().nr_invert(_ptr(clip), clip.size)
    return clip


def posterize(clip, bits):
    clip = _prep(clip)
    # clamp to [1, 8]: Pillow's posterize rejects bits outside this range,
    # and 8-bits would shift by a negative count (UB) in the kernel
    _require_lib().nr_posterize(_ptr(clip), clip.size,
                                min(8, max(1, int(bits))))
    return clip


def solarize(clip, thresh):
    clip = _prep(clip)
    _require_lib().nr_solarize(_ptr(clip), clip.size, int(thresh))
    return clip


def solarize_add(clip, add):
    clip = _prep(clip)
    _require_lib().nr_solarize_add(_ptr(clip), clip.size, int(add))
    return clip


def brightness(clip, factor):
    clip = _prep(clip)
    _require_lib().nr_brightness(_ptr(clip), clip.size, float(factor))
    return clip


def auto_contrast(clip):
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    _require_lib().nr_autocontrast(_ptr(clip), f, h, w)
    return clip


def equalize(clip):
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    _require_lib().nr_equalize(_ptr(clip), f, h, w)
    return clip


def contrast(clip, factor):
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    _require_lib().nr_contrast(_ptr(clip), f, h, w, float(factor))
    return clip


def color(clip, factor):
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    _require_lib().nr_color(_ptr(clip), f, h, w, float(factor))
    return clip


def sharpness(clip, factor):
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    dst = np.empty_like(clip)
    _require_lib().nr_sharpness(_ptr(clip), _ptr(dst), f, h, w, float(factor))
    return dst


def affine(clip, coeffs):
    """Pillow Image.transform(size, AFFINE, coeffs, BILINEAR) per frame."""
    clip = _prep(clip)
    f, h, w, _ = clip.shape
    a, b, c, d, e, ff = (float(v) for v in coeffs)
    dst = np.empty_like(clip)
    _require_lib().nr_affine_bilinear(_ptr(clip), _ptr(dst), f, h, w,
                                      a, b, c, d, e, ff)
    return dst


def shear_x(clip, factor):
    return affine(clip, (1.0, factor, 0.0, 0.0, 1.0, 0.0))


def shear_y(clip, factor):
    return affine(clip, (1.0, 0.0, 0.0, factor, 1.0, 0.0))


def translate_x(clip, frac):
    w = clip.shape[-2]
    return affine(clip, (1.0, 0.0, frac * w, 0.0, 1.0, 0.0))


def translate_y(clip, frac):
    h = clip.shape[-3] if clip.ndim == 4 else clip.shape[0]
    return affine(clip, (1.0, 0.0, 0.0, 0.0, 1.0, frac * h))


def rotate(clip, degrees):
    """Pillow Image.rotate(degrees, BILINEAR, expand=False) coefficients,
    replicated exactly (incl. the %360 and round(..., 15))."""
    h = clip.shape[-3] if clip.ndim == 4 else clip.shape[0]
    w = clip.shape[-2]
    angle = degrees % 360.0
    rotn_center = (w / 2.0, h / 2.0)
    rad = -math.radians(angle)
    matrix = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
              round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y, m):
        (a, b, c, d, e, f) = m
        return a * x + b * y + c, d * x + e * y + f

    matrix[2], matrix[5] = transform(-rotn_center[0], -rotn_center[1], matrix)
    matrix[2] += rotn_center[0]
    matrix[5] += rotn_center[1]
    return affine(clip, matrix)


def identity(clip):
    return _prep(clip)
