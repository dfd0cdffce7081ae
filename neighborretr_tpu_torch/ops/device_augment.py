"""RandAugment on the device, inside the train step (↔ neighborretr_tpu/ops/
device_augment.py, `--augment_backend device`).

The loader then ships raw uint8 clips and the policy's pixel work runs
where the batch already lies, ahead of the model's frame normalisation.
Plain PyTorch on either device: the JAX module has no TPU kernel, so there
is no hand kernel here either.

The function is the JAX module's, stage for stage:

* per CLIP draws (its frames share them): N layers, each one of the 16 ops
  of `OP_NAMES`, firing with probability p, magnitude m + N(0, mstd)
  clipped to [0, 10], a sign;
* each layer's VALUE ops in layer order, rounded back to uint8 after every
  op (AutoContrast, Contrast and Brightness as one per-channel linear map,
  Color and Sharpness as blends, the solarize family, Posterize);
* then ONE Equalize of every clip where any layer fired it, its histogram
  on a stride-subsampled pixel grid;
* then ONE warp of the composed affine map of every fired geometric op:
  the JAX module's two-pass separable bilinear warp (a horizontal pass at
  positions pre-composed with the vertical map's inverse, rounded to bf16,
  then a vertical pass), taps clamped from the unclipped floor, zero outside
  the source, each tap weight rounded to bf16 as the TPU's interpolation
  matrix entries are.

What does not carry over are the TPU's workarounds, since a GPU gathers per
element: the channel-major layout, the interpolation matrices (a
[B, H, W, W] bf16 operand, 2.9 GB at batch 128 x 224²) and the
compare-select LUT reductions become two-tap gathers, `bincount`
histograms and gathered LUTs.  Each op runs on the clips that drew it only.

The one intended difference: no slot cap.  The JAX module runs its costly
ops on at most max(8, ⌈B/6⌉) active clips per layer and silently skips the
rest (a TPU cost device; there a Contrast clip past the slots gets a gray
mean of 0, a brightness change).  Here every clip that draws an op gets it,
which equals the JAX result whenever the active clips fit the slots, as
they always do at B <= 8.

`sample_policy` draws from an explicit `torch.Generator`;
`apply_randaugment_draws` takes the draws as tensors (the tests hand it the
JAX module's own draws); `augment_batch` is what the train step calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# the host backend's op table order (data/augment.py::_RAND_OPS), so that
# both backends sample the same categorical distribution
OP_NAMES = (
    "AutoContrast", "Equalize", "Invert", "Identity", "Posterize",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
)
_OP = {name: i for i, name in enumerate(OP_NAMES)}
_GEOMETRIC = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
_MAX_LEVEL = 10.0


@dataclasses.dataclass(frozen=True)
class DeviceAugmentPolicy:
    """Parsed rand-mM-nN-mstdS[-pP]-inc1 policy (timm's grammar, as the host
    backend's RandAugment.from_config_str parses it)."""
    magnitude: int = 7
    num_layers: int = 4
    magnitude_std: float = 0.5
    prob: float = 0.5
    hist_stride: int = 4    # equalize-histogram pixel subsampling stride

    @classmethod
    def parse(cls, config: str) -> "DeviceAugmentPolicy":
        parts = config.split("-")
        if parts[0] != "rand":
            raise ValueError(f"not a rand-augment config: '{config}'")
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
                pass
            else:
                raise ValueError(
                    f"unsupported RandAugment config segment '{p}' in "
                    f"'{config}' (supported: mN, nN, mstdF, pF, inc1)")
        return cls(**kwargs)


def sample_policy(generator: torch.Generator, batch: int,
                  pol: DeviceAugmentPolicy):
    """Per-clip draws for all layers, on the generator's device: (op_idx
    [B, N] int64, fire [B, N] bool, level [B, N] fp32 in [0, 10], neg
    [B, N] bool)."""
    kw = dict(generator=generator, device=generator.device)
    shape = (batch, pol.num_layers)
    op_idx = torch.randint(0, len(OP_NAMES), shape, **kw)
    fire = torch.rand(shape, **kw) < pol.prob
    level = (pol.magnitude + pol.magnitude_std * torch.randn(shape, **kw)
             ).clamp(0.0, _MAX_LEVEL)
    neg = torch.rand(shape, **kw) < 0.5
    return op_idx, fire, level, neg


# ---------------------------------------------------------------------------
# value ops, on the clips that drew them: uint8 [m, F, H, W, C] → uint8
# ---------------------------------------------------------------------------

def _div(a, b: float) -> torch.Tensor:
    """a / b for a number b, a true fp32 division on either device (CUDA
    multiplies by the reciprocal of a host scalar instead, an ulp off)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """PIL's 'L' conversion on [..., 3] pixels → int32 [...]:
    (19595 r + 38470 g + 7471 b + 0x8000) >> 16."""
    x = x.to(torch.int32)
    return (19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2]
            + 0x8000) >> 16


def _smooth(x: torch.Tensor) -> torch.Tensor:
    """PIL's ImageFilter.SMOOTH over H, W of [..., H, W, C] uint8 → fp32:
    3x3 kernel (centre 5, ring 1) / 13, +0.5 floored, border pixels copied.
    The nine taps are summed as integers (exact), then scaled as the JAX
    module scales them."""
    xi = x.to(torch.int32)
    H, W = x.shape[-3], x.shape[-2]
    acc = 5 * xi[..., 1:-1, 1:-1, :]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc + xi[..., 1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx, :]
    out = x.float()
    out[..., 1:-1, 1:-1, :] = torch.floor(acc.float() * (1.0 / 13.0) + 0.5)
    return out


def _to_u8(xf: torch.Tensor) -> torch.Tensor:
    """A layer's end: floor, clip to the pixel range, back to uint8."""
    return torch.floor(xf.clamp(0.0, 255.0)).to(torch.uint8)


def _clip_param(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1, 1, 1, 1, 1)


def _autocontrast(x, frac, enh):
    xf = x.float()
    lo = x.amin(dim=(2, 3), keepdim=True).float()        # [m, F, 1, 1, C]
    hi = x.amax(dim=(2, 3), keepdim=True).float()
    span = hi - lo
    ok = span > 0
    scale = torch.where(ok, torch.full_like(span, 255.0) / span.clamp_min(1.0),
                        1.0)
    off = torch.where(ok, -lo * scale, 0.0)
    return _to_u8(scale * xf + off)


def _contrast(x, frac, enh):
    """PIL's ImageEnhance.Contrast: towards the frame's gray mean,
    int(mean_L + 0.5).  The sum of integers is exact in any order; the mean
    is the sum times the fp32 reciprocal of the count, as jnp.mean takes
    it."""
    H, W = x.shape[2], x.shape[3]
    gray = _grayscale(x).sum(dim=(2, 3), dtype=torch.int64)        # [m, F]
    mean = torch.floor(gray.float() * (torch.tensor(1.0) / (H * W)) + 0.5)
    a = _clip_param(enh)
    return _to_u8(a * x.float() + mean[:, :, None, None, None] * (1.0 - a))


def _brightness(x, frac, enh):
    return _to_u8(_clip_param(enh) * x.float())


def _invert(x, frac, enh):
    return 255 - x


def _solarize(x, frac, enh):
    t = _clip_param(256.0 - torch.floor(frac * 256.0))
    xf = x.float()
    return torch.where(xf >= t, 255.0 - xf, xf).to(torch.uint8)


def _solarize_add(x, frac, enh):
    add = _clip_param(torch.floor(frac * 110.0))
    xf = x.float()
    return torch.where(xf < 128.0, (xf + add).clamp(max=255.0),
                       xf).to(torch.uint8)


def _posterize(x, frac, enh):
    """Bits 4 → 1 as the level grows (inc1): keep the top bits."""
    bits = (4 - torch.floor(frac * 4.0).to(torch.int32)).clamp_min(1)
    step = _clip_param((2 ** (8 - bits)).float())
    return (torch.floor(x.float() / step) * step).to(torch.uint8)


def _color(x, frac, enh):
    g = _grayscale(x).float()[..., None]
    return _to_u8(g + _clip_param(enh) * (x.float() - g))


def _sharpness(x, frac, enh):
    sm = _smooth(x)
    return _to_u8(sm + _clip_param(enh) * (x.float() - sm))


_VALUE_OPS = {"AutoContrast": _autocontrast, "Contrast": _contrast,
              "Brightness": _brightness, "Invert": _invert,
              "Solarize": _solarize, "SolarizeAdd": _solarize_add,
              "Posterize": _posterize, "Color": _color,
              "Sharpness": _sharpness}


# ---------------------------------------------------------------------------
# equalize
# ---------------------------------------------------------------------------

def _equalize_lut(hist: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIL's ImageOps.equalize LUT from histograms [..., 256] of subsampled
    counts (`scale` = stride², back to full-image counts) → (lut [..., 256]
    fp32 in [0, 255], identity [...] bool where PIL does nothing: at most
    one occupied bin, or an integer step of 0).  Every sum is of integers
    below 2^24, exact in fp32 in any order."""
    h = hist * scale
    nz = hist > 0
    n_occupied = nz.sum(dim=-1)
    # the count in the highest occupied bin (PIL drops it from the step)
    last = 255 - torch.argmax(nz.flip(-1).to(torch.int32), dim=-1)
    h_last = torch.gather(h, -1, last[..., None])[..., 0]
    total = h.sum(dim=-1)
    step = torch.floor(_div(total - h_last, 255.0))
    ident = (n_occupied <= 1) | (step <= 0)
    step = step.clamp_min(1.0)
    cum_excl = torch.cumsum(h, dim=-1) - h
    lut = torch.floor((torch.floor(step / 2.0)[..., None] + cum_excl)
                      / step[..., None])
    return lut.clamp(0.0, 255.0), ident


def _equalize(x: torch.Tensor, pol: DeviceAugmentPolicy) -> torch.Tensor:
    """Equalize every frame and channel of x [m, F, H, W, C] uint8, the
    histogram on every stride-th row and column."""
    m, F, H, W, C = x.shape
    stride = max(1, min(pol.hist_stride, H // 8 or 1, W // 8 or 1))
    # one 256-bin histogram per (clip, frame, channel): bin offsets
    base = (torch.arange(m * F * C, device=x.device) * 256).view(m, F, 1, 1, C)
    sub = x[:, :, ::stride, ::stride, :].long() + base
    hist = torch.bincount(sub.reshape(-1), minlength=m * F * C * 256)
    lut, ident = _equalize_lut(hist.view(m, F, C, 256).float(),
                               float(stride * stride))
    ramp = torch.arange(256, dtype=torch.float32, device=x.device)
    table = torch.where(ident[..., None], ramp, lut).to(torch.uint8)
    return table.reshape(-1)[x.long() + base]


# ---------------------------------------------------------------------------
# geometric ops: one composed affine map, one two-pass warp
# ---------------------------------------------------------------------------

def _affine_matrices(op_idx, fire, level, neg, H: int, W: int
                     ) -> torch.Tensor:
    """Per-clip inverse maps [B, 6] (a, b, c, d, e, f) of one layer:
    src_x = a·(x+.5) + b·(y+.5) + c, src_y = d·(x+.5) + e·(y+.5) + f,
    the identity unless a geometric op fired (PIL's transform() takes the
    inverse map; rotation by θ about the image centre)."""
    sign = torch.where(neg, -1.0, 1.0)
    frac = _div(level, _MAX_LEVEL)
    shear = 0.3 * frac * sign
    trans = 0.45 * frac * sign
    theta = (30.0 * frac * sign) * (math.pi / 180.0)

    def act(name):
        return fire & (op_idx == _OP[name])

    one, zero = torch.ones_like(level), torch.zeros_like(level)
    a, b, c, d, e, f = one, zero, zero, zero, one, zero
    b = torch.where(act("ShearX"), shear, b)
    d = torch.where(act("ShearY"), shear, d)
    c = torch.where(act("TranslateX"), trans * W, c)
    f = torch.where(act("TranslateY"), trans * H, f)
    rot = act("Rotate")
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = W / 2.0, H / 2.0
    a = torch.where(rot, cos, a)
    b = torch.where(rot, -sin, b)
    c = torch.where(rot, cx - cos * cx + sin * cy, c)
    d = torch.where(rot, sin, d)
    e = torch.where(rot, cos, e)
    f = torch.where(rot, cy - sin * cx - cos * cy, f)
    return torch.stack([a, b, c, d, e, f], dim=-1)


def compose_affine(mats: torch.Tensor) -> torch.Tensor:
    """Per-layer inverse maps [B, N, 6] → the inverse map of the ops applied
    in layer order, [B, 6]: M_1 ∘ M_2 ∘ … ∘ M_N (the first op outermost)."""
    a, b, c, d, e, f = mats[:, 0].unbind(-1)
    for i in range(1, mats.shape[1]):
        a2, b2, c2, d2, e2, f2 = mats[:, i].unbind(-1)
        a, b, c, d, e, f = (a * a2 + b * d2, a * b2 + b * e2,
                            a * c2 + b * f2 + c, d * a2 + e * d2,
                            d * b2 + e * e2, d * c2 + e * f2 + f)
    return torch.stack([a, b, c, d, e, f], dim=-1)


def _taps(pos: torch.Tensor, size: int):
    """The two-tap sample plan of positions pos [...] in PIL's convention
    (pixel i covers [i, i+1)) → (i0, w0, i1, w1): taps clamped from the
    unclipped floor of pos - 0.5, weights rounded to bf16 as the TPU's
    interpolation-matrix entries are (where both taps clamp onto one texel,
    its single entry (1-f)+f), both zero where pos leaves [0, size)."""
    valid = (pos >= 0) & (pos < size)
    g = pos - 0.5
    t0f = torch.floor(g)
    f = g - t0f
    t0i = t0f.to(torch.int64)
    i0 = t0i.clamp(0, size - 1)
    i1 = (t0i + 1).clamp(0, size - 1)
    same = i0 == i1
    w0 = torch.where(same, (1.0 - f) + f, 1.0 - f)
    w1 = torch.where(same, 0.0, f)

    def rnd(w):
        return torch.where(valid, w, 0.0).bfloat16().float()

    return i0, rnd(w0), i1, rnd(w1)


def _resample(x: torch.Tensor, dim: int, plan) -> torch.Tensor:
    """Two taps along `dim` of x [m, F, H, W, C]; the plan's tensors are
    [m, H, W] (output rows, output columns) → fp32, one rounding of the
    exact products' sum, as the TPU's fp32-accumulated matmul gives."""
    i0, w0, i1, w1 = (t[:, None, :, :, None] for t in plan)
    shape = x.shape

    def tap(i):
        return torch.gather(x, dim, i.expand(shape)).float()

    return tap(i0) * w0 + tap(i1) * w1


def _warp(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Bilinear affine warp of x [m, F, H, W, C] uint8 by the per-clip
    inverse maps coeff [m, 6], as two separable passes: horizontal at
    X1(r, x) = (a - bd/e)·x + (b/e)·r + (c - bf/e) over the source rows r
    (|e| kept >= 0.05 here only), the result rounded to bf16, then vertical
    at Y2(y, x) = d·x + e·y + f; floor(out + 0.5), clipped."""
    m, F, H, W, C = x.shape
    a, b, c, d, e, f = (coeff[:, i].view(m, 1, 1) for i in range(6))
    e_safe = torch.where(e.abs() < 0.05, torch.where(e < 0, -0.05, 0.05), e)
    a1 = a - b * d / e_safe
    b1 = b / e_safe
    c1 = c - b * f / e_safe
    xs = torch.arange(W, dtype=torch.float32, device=x.device) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=x.device) + 0.5
    pos1 = a1 * xs[None, None, :] + b1 * ys[None, :, None] + c1   # [m, r, x]
    mid = _resample(x, 3, _taps(pos1, W)).bfloat16()
    pos2 = d * xs[None, None, :] + e * ys[None, :, None] + f     # [m, y, x]
    out = _resample(mid, 2, _taps(pos2, H))
    return torch.floor(out + 0.5).clamp(0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def apply_randaugment_draws(video_u8: torch.Tensor, op_idx, fire, level, neg,
                            policy: "DeviceAugmentPolicy | str"
                            ) -> torch.Tensor:
    """uint8 [B, F, H, W, 3] and the draws [B, N] (`sample_policy`'s) →
    augmented uint8 on the video's device.  Stage order: every layer's value
    ops in layer order, one Equalize where any layer fired it, one warp of
    the composed geometric ops."""
    if isinstance(policy, str):
        policy = DeviceAugmentPolicy.parse(policy)
    if video_u8.dtype != torch.uint8:
        raise TypeError(
            f"device augment expects uint8 frames, got {video_u8.dtype} "
            "(is the host pipeline already normalizing?)")
    B, F, H, W, C = video_u8.shape
    dev = video_u8.device
    level = torch.as_tensor(level, dtype=torch.float32, device=dev)
    neg = torch.as_tensor(neg, device=dev)
    # which clips run which op: planned on the host, one transfer
    op_h = torch.as_tensor(op_idx).cpu()
    fire_h = torch.as_tensor(fire).cpu()
    frac = _div(level, _MAX_LEVEL)
    enh = 1.0 + 0.9 * frac
    enh = torch.where(neg, 2.0 - enh, enh)      # the enhance mirror

    def clips(mask):
        return torch.nonzero(mask).flatten().to(dev)

    x = video_u8.clone()
    for layer in range(op_h.shape[1]):
        for name, fn in _VALUE_OPS.items():
            idx = clips(fire_h[:, layer] & (op_h[:, layer] == _OP[name]))
            if len(idx):
                x[idx] = fn(x[idx], frac[idx, layer], enh[idx, layer])
    idx = clips((fire_h & (op_h == _OP["Equalize"])).any(dim=1))
    if len(idx):
        x[idx] = _equalize(x[idx], policy)
    geometric = torch.tensor([_OP[name] for name in _GEOMETRIC])
    idx = clips((fire_h & torch.isin(op_h, geometric)).any(dim=1))
    if len(idx):
        op_d, fire_d = op_h.to(dev)[idx], fire_h.to(dev)[idx]
        mats = torch.stack([_affine_matrices(
            op_d[:, i], fire_d[:, i], level[idx, i], neg[idx, i], H, W)
            for i in range(op_h.shape[1])], dim=1)
        x[idx] = _warp(x[idx], compose_affine(mats))
    return x


def apply_randaugment(video_u8: torch.Tensor, generator: torch.Generator,
                      policy: "DeviceAugmentPolicy | str", rank: int = 0,
                      world: int = 1) -> torch.Tensor:
    """uint8 [B, F, H, W, 3] → augmented uint8, the draws taken from
    `generator` (on the video's device).  With world > 1 the clips are
    block `rank` of a global batch of world·B: the draws are taken for the
    global batch and the block's rows applied, so each clip gets the draws
    it gets in one process over the whole batch."""
    if isinstance(policy, str):
        policy = DeviceAugmentPolicy.parse(policy)
    B = video_u8.shape[0]
    draws = sample_policy(generator, B * world, policy)
    draws = [d[rank * B:(rank + 1) * B] for d in draws]
    return apply_randaugment_draws(video_u8, *draws, policy)


def augment_batch(video_u8: torch.Tensor, video_mask: torch.Tensor,
                  generator: torch.Generator,
                  policy: "DeviceAugmentPolicy | str", rank: int = 0,
                  world: int = 1) -> torch.Tensor:
    """Masked batch augment: padding frames (video_mask [B, F] == 0) stay
    exactly zero, as the host pipeline leaves them (Invert would map 0 to
    255, SolarizeAdd would add).  rank / world: see apply_randaugment."""
    out = apply_randaugment(video_u8, generator, policy, rank, world)
    keep = (video_mask > 0)[:, :, None, None, None]
    return torch.where(keep, out, torch.zeros_like(out))
