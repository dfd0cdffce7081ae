"""Train-time video augmentation + decode cache (host-side, worker processes).

Re-designed counterparts of the reference's timm-style augmentation library
(dataloaders/{video_transforms,rand_augment}.py, ~2.4k LoC) and the decode
LRU cache (rawvideo_util.py:28-88):

- `RandAugment`: the `rand-m7-n4-mstd0.5-inc1` policy used at train time
  (dataloader_retrieval.py:154-158) — N=4 ops drawn per clip, magnitude 7
  jittered with std 0.5, increasing-with-magnitude ranges.  The SAME sampled
  ops are applied to every frame of a clip (temporal consistency), matching
  `create_random_augment` being applied to the whole PIL-frame list
  (rawvideo_util.py:291-293).
- `process_frame_order`: normal / reverse / random frame shuffling
  (rawvideo_util.py:331-371).
- `ClipLRUCache`: thread-safe LRU keyed on (path, mtime, params)
  (rawvideo_util.py:42-88,202-216).  Caches the *decoded uint8 array* only —
  augmentation is applied after cache retrieval so each epoch re-augments.

Pixel math is done in numpy/PIL on uint8 HWC frames (the host format of
`decode_video_frames`); bit-exact parity with timm is NOT a spec requirement
(SURVEY §7 "hard parts": RandAugment parity not required bit-for-bit).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image, ImageEnhance, ImageOps
    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

_MAX_LEVEL = 10.0


# ---------------------------------------------------------------------------
# Individual ops: uint8 HWC ndarray -> uint8 HWC ndarray
# ---------------------------------------------------------------------------

def _pil(fn: Callable) -> Callable:
    def wrapped(img: np.ndarray, *a) -> np.ndarray:
        return np.asarray(fn(Image.fromarray(img), *a))
    return wrapped


@_pil
def _auto_contrast(im):
    return ImageOps.autocontrast(im)


@_pil
def _equalize(im):
    return ImageOps.equalize(im)


@_pil
def _invert(im):
    return ImageOps.invert(im)


@_pil
def _posterize(im, bits):
    return ImageOps.posterize(im, max(1, int(bits)))


@_pil
def _solarize(im, thresh):
    return ImageOps.solarize(im, int(thresh))


def _solarize_add(arr, add):
    # pure numpy (no PIL round-trip: the @_pil wrapper would add four
    # full-frame copies per application on the decode-pool hot path)
    a = arr.astype(np.int16)
    out = np.where(a < 128, np.clip(a + int(add), 0, 255), a)
    return out.astype(np.uint8)


@_pil
def _color(im, factor):
    return ImageEnhance.Color(im).enhance(factor)


@_pil
def _contrast(im, factor):
    return ImageEnhance.Contrast(im).enhance(factor)


@_pil
def _brightness(im, factor):
    return ImageEnhance.Brightness(im).enhance(factor)


@_pil
def _sharpness(im, factor):
    return ImageEnhance.Sharpness(im).enhance(factor)


@_pil
def _shear_x(im, factor):
    return im.transform(im.size, Image.AFFINE, (1, factor, 0, 0, 1, 0),
                        resample=Image.BILINEAR)


@_pil
def _shear_y(im, factor):
    return im.transform(im.size, Image.AFFINE, (1, 0, 0, factor, 1, 0),
                        resample=Image.BILINEAR)


@_pil
def _translate_x(im, frac):
    pixels = frac * im.size[0]
    return im.transform(im.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                        resample=Image.BILINEAR)


@_pil
def _translate_y(im, frac):
    pixels = frac * im.size[1]
    return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                        resample=Image.BILINEAR)


@_pil
def _rotate(im, degrees):
    return im.rotate(degrees, resample=Image.BILINEAR)


def _identity(img: np.ndarray) -> np.ndarray:
    return img


# level -> op args, "inc1" (increasing with magnitude) variants
def _enhance_level(level: float) -> Tuple[float]:
    return (1.0 + (level / _MAX_LEVEL) * 0.9,)   # inc: 1.0 -> 1.9


def _shear_level(level: float) -> Tuple[float]:
    return ((level / _MAX_LEVEL) * 0.3,)


def _translate_level(level: float) -> Tuple[float]:
    return ((level / _MAX_LEVEL) * 0.45,)


def _rotate_level(level: float) -> Tuple[float]:
    return ((level / _MAX_LEVEL) * 30.0,)


def _posterize_inc_level(level: float) -> Tuple[int]:
    # inc: FEWER bits (stronger) as magnitude rises, 4 → 1 (timm's
    # _posterize_increasing; floor 1 since ImageOps.posterize needs ≥1 bit)
    return (max(1, 4 - int((level / _MAX_LEVEL) * 4)),)

def _solarize_inc_level(level: float) -> Tuple[int]:
    return (256 - int((level / _MAX_LEVEL) * 256),)

def _solarize_add_level(level: float) -> Tuple[int]:
    return (int((level / _MAX_LEVEL) * 110),)


# (op fn, level fn or None, signed) — the PIL/numpy per-frame backend
_RAND_OPS: Dict[str, Tuple[Callable, Optional[Callable], bool]] = {
    "AutoContrast": (_auto_contrast, None, False),
    "Equalize": (_equalize, None, False),
    "Invert": (_invert, None, False),
    "Identity": (_identity, None, False),
    "Posterize": (_posterize, _posterize_inc_level, False),
    "Solarize": (_solarize, _solarize_inc_level, False),
    "SolarizeAdd": (_solarize_add, _solarize_add_level, False),
    "Color": (_color, _enhance_level, True),
    "Contrast": (_contrast, _enhance_level, True),
    "Brightness": (_brightness, _enhance_level, True),
    "Sharpness": (_sharpness, _enhance_level, True),
    "ShearX": (_shear_x, _shear_level, True),
    "ShearY": (_shear_y, _shear_level, True),
    "TranslateX": (_translate_x, _translate_level, True),
    "TranslateY": (_translate_y, _translate_level, True),
    "Rotate": (_rotate, _rotate_level, True),
}

# enhance-style ops whose signed mirror is 2-factor, not negation
_ENHANCE_OPS = frozenset({"Color", "Contrast", "Brightness", "Sharpness"})


def _native_ops() -> Dict[str, Callable]:
    """Name -> whole-clip native op (data/native: byte-exact C++ kernels,
    built on first use).  Import deferred so the PIL path never pays a
    compiler invocation."""
    from . import native as N
    return {
        "AutoContrast": N.auto_contrast, "Equalize": N.equalize,
        "Invert": N.invert, "Identity": N.identity,
        "Posterize": N.posterize, "Solarize": N.solarize,
        "SolarizeAdd": N.solarize_add, "Color": N.color,
        "Contrast": N.contrast, "Brightness": N.brightness,
        "Sharpness": N.sharpness, "ShearX": N.shear_x, "ShearY": N.shear_y,
        "TranslateX": N.translate_x, "TranslateY": N.translate_y,
        "Rotate": N.rotate,
    }


class RandAugment:
    """rand-mM-nN-mstdS-inc1 policy over uint8 HWC frames.

    `__call__` samples N ops once and applies them to *all* frames in the
    clip, mirroring the reference applying one `create_random_augment`
    transform to the full PIL-frame list (rawvideo_util.py:291-293).
    """

    def __init__(self, magnitude: int = 7, num_layers: int = 4,
                 magnitude_std: float = 0.5, prob: float = 0.5,
                 rng: Optional[np.random.Generator] = None,
                 backend: str = "auto"):
        self.magnitude = magnitude
        self.num_layers = num_layers
        self.magnitude_std = magnitude_std
        # each selected op applies with this probability (timm AugmentOp's
        # default 0.5 — without it the effective policy strength doubles)
        self.prob = prob
        self.rng = rng or np.random.default_rng()
        # 'pil' | 'native' | 'auto'.  The native (C++) backend is byte-exact
        # vs the PIL path (tests/test_native_augment.py) at a fraction of the
        # per-core cost, so 'auto' prefers it and falls back to PIL when no
        # compiler is available.  Op/arg SAMPLING is backend-independent
        # (same rng stream -> same ops either way).
        if backend not in ("pil", "native", "auto"):
            raise ValueError(f"unknown augment backend '{backend}'")
        if backend == "auto":
            from . import native as _native
            backend = "native" if _native.available() else "pil"
        elif backend == "native":
            from . import native as _native
            if not _native.available():
                raise RuntimeError(
                    f"native augment backend unavailable: "
                    f"{_native.load_error()}")
        self.backend = backend
        self._native = _native_ops() if backend == "native" else None

    @classmethod
    def from_config_str(cls, config: str,
                        rng: Optional[np.random.Generator] = None,
                        backend: str = "auto"):
        """Parse a timm-style 'rand-m7-n4-mstd0.5-inc1' string.  Unsupported
        segments raise — silently dropping e.g. 'inc0' or 'p0.3' would run a
        different policy than the one named."""
        parts = config.split("-")
        assert parts[0] == "rand", config
        kwargs = {}
        for p in parts[1:]:
            if p.startswith("mstd"):
                kwargs["magnitude_std"] = float(p[4:])
            elif p.startswith("p") and p[1:2].isdigit():
                kwargs["prob"] = float(p[1:])
            elif p.startswith("m") and p[1:].isdigit():
                kwargs["magnitude"] = int(p[1:])
            elif p.startswith("n") and p[1:].isdigit():
                kwargs["num_layers"] = int(p[1:])
            elif p == "inc1":
                pass            # increasing ranges — the implemented style
            else:
                raise ValueError(
                    f"unsupported RandAugment config segment '{p}' in "
                    f"'{config}' (supported: mN, nN, mstdF, pF, inc1)")
        return cls(rng=rng, backend=backend, **kwargs)

    def _sample_ops(self, rng: np.random.Generator
                    ) -> List[Tuple[str, tuple]]:
        """Draw the clip's (op name, args) list.  Identical rng consumption
        for every backend, so the sampled policy is backend-independent."""
        names = rng.choice(list(_RAND_OPS), size=self.num_layers)
        ops = []
        for name in names:
            if rng.random() >= self.prob:     # timm: each op fires w.p. 0.5
                continue
            _, level_fn, signed = _RAND_OPS[name]
            if level_fn is None:
                ops.append((name, ()))
                continue
            level = self.magnitude + rng.normal(0, self.magnitude_std)
            level = float(np.clip(level, 0, _MAX_LEVEL))
            args = level_fn(level)
            if signed and rng.random() < 0.5:
                args = tuple(-a if isinstance(a, float) else a for a in args)
                if name in _ENHANCE_OPS:
                    # enhance factors mirror around 1.0 rather than negate
                    args = (2.0 - level_fn(level)[0],)
            ops.append((name, args))
        return ops

    def __call__(self, frames: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """frames uint8 [F, H, W, 3] -> augmented uint8 [F, H, W, 3].
        `rng`: per-item generator (thread-safe, epoch-seeded — see
        datasets/base.py item()); falls back to the instance one."""
        if self.backend == "pil" and not _HAS_PIL:
            return frames
        ops = self._sample_ops(rng if rng is not None else self.rng)
        if not ops:
            return frames
        if self._native is not None:
            # whole-clip C++ kernels; copy first — in-place ops must never
            # mutate the (shared) decode-cache buffer.  ctypes releases the
            # GIL during each call, so thread-pool workers run concurrently.
            clip = frames.copy()
            for name, args in ops:
                clip = self._native[name](clip, *args)
            return clip
        out = np.empty_like(frames)
        for i in range(frames.shape[0]):
            img = frames[i]
            for name, args in ops:
                img = _RAND_OPS[name][0](img, *args)
            out[i] = img
        return out


def create_random_augment(config_str: str = "rand-m7-n4-mstd0.5-inc1",
                          rng: Optional[np.random.Generator] = None,
                          backend: str = "auto") -> RandAugment:
    """Factory mirroring video_transforms.create_random_augment:632-667."""
    return RandAugment.from_config_str(config_str, rng=rng, backend=backend)


# ---------------------------------------------------------------------------
# Frame-order processing (rawvideo_util.py:331-371)
# ---------------------------------------------------------------------------

def process_frame_order(frames: np.ndarray, order: int = 0,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """order 0: as-is; 1: reverse; 2: random permutation."""
    if order == 0:
        return frames
    if order == 1:
        return frames[::-1].copy()
    if order == 2:
        rng = rng or np.random.default_rng()
        return frames[rng.permutation(frames.shape[0])]
    raise ValueError(f"unknown frame order {order}")


# ---------------------------------------------------------------------------
# Thread-safe decode LRU cache (rawvideo_util.py:28-88,202-216)
# ---------------------------------------------------------------------------

class ClipLRUCache:
    """LRU over decoded (frames, mask) keyed on (path, mtime, params)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._store: "OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return None

    def put(self, key: tuple, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
