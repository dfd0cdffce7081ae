"""Fused pre-LN attention sublayer, forward and backward (↔ neighborretr_tpu/
ops/pallas_block_attention.py::fused_ln_attention_residual and its custom VJP).

    y = x + W_o · MHA(LN(x) · W_qkv + b_qkv) + b_o        per sequence

with an optional additive fp32 attention bias [N, L, L] (text causal∧padding,
temporal key padding).  Weights are the module's own tensors in torch's
layout: `w_qkv` is `in_proj_weight` [3D, D] (the transpose of the TPU
kernel's input-major [D, 3D]) and `w_out` is `out_proj.weight` [D, D].

`ln_attention_residual_plain` is the plain PyTorch version.  It rounds to
x's dtype at the TPU kernel's rounding points (h, qkv, scaled q, probs,
attn_out) and multiplies in fp32, so with a bf16 x it emulates the kernel's
bf16 operands with fp32 accumulation, and with an fp32 x it is exactly
layer_norm + fp32 attention + residual.  `ln_attention_residual` is the
kernel's wrapper: a CPU tensor takes the plain version; a CUDA tensor runs
csrc/ln_attention_residual.cu, which takes bf16 activations only.

The backward has the same three forms.  `ln_attention_residual_bwd_plain`
is written out by hand with the TPU kernel's rounding points (g, dattn and
dqkv are rounded too, which autograd through `.to(bf16).float()` would not
do); `ln_attention_residual_bwd` runs csrc/ln_attention_residual_bwd.cu on a
CUDA tensor.  Nothing is saved by the forward but its inputs: the backward
recomputes LN, qkv and the probabilities.  `ln_attention_sublayer` joins
forward and backward in one autograd function; it is what the model calls.

The same sublayer without LayerNorm and residual, y = W_o · MHA(h) + b_o on
a pre-normalised h (↔ the same JAX file's fused_attention_sublayer, whose
four TPU kernels no model path calls), has the same three forms:
`attention_sublayer_plain` / `attention_sublayer_bwd_plain`, and the wrappers
`attention_sublayer` (K10) / `attention_sublayer_bwd` (K11), which run the
same CUDA sources with LayerNorm and residual compiled out.
`fused_attention_sublayer` is its public, differentiable form with the JAX
function's casts.

The CUDA kernels run as stages over all N·L rows (csrc/sublayer.cuh): the
LayerNorm rows, a GEMM with one of five epilogues, K8/K9's attention core
(its backward also summing each sequence's dqkv columns in fp32 for
db_qkv), the LayerNorm-backward rows.  Each stage has a plain version here
(`sublayer_gemm_plain`, `attention_core_bwd_plain`, `ln_bwd_rows_plain`),
the first two a wrapper that runs the stage alone for its tests
(`sublayer_gemm`, `attention_core_bwd`); `sublayer_fwd_stages_plain` and
`sublayer_bwd_stages_plain` compose them as the kernels do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import attention_core

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm as an fp32 island: computed in fp32, cast back to x's
    dtype (↔ models/layers.py::layer_norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * rstd * weight.float() + bias.float()).to(x.dtype)


def mha(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
        bias=None) -> torch.Tensor:
    """Plain multi-head self-attention, einsum form (↔ models/layers.py::mha
    with fused=False): h [N, L, D] post-LN, bias [N, L, L] or None.
    Operands are rounded to h's dtype at the TPU kernel's rounding points
    and multiplied in fp32 (the attention itself is ops/attention.py's
    `attention_core`); returns the fp32 sublayer output before the
    residual."""
    dt = h.dtype

    def rnd(t):                      # round to the operand dtype, keep fp32
        return t.to(dt).float()

    qkv = (h.float() @ rnd(w_qkv).T + b_qkv.float()).to(dt)
    out, _ = attention_core(qkv, n_head, bias)
    return out @ rnd(w_out).T + b_out.float()


def ln_attention_residual_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                n_head: int, bias=None) -> torch.Tensor:
    """The kernel's plain version: x + mha(LN(x)), the residual added in
    fp32 and the result returned in x's dtype."""
    x32 = x.float()
    h = layer_norm(x32, ln_w, ln_b).to(x.dtype)
    y = mha(h, w_qkv, b_qkv, w_out, b_out, n_head, bias) + x32
    return y.to(x.dtype)


def _mha_bwd(h, w_qkv, b_qkv, w_out, n_head: int, g, bias, dt):
    """The backward of `mha` from g = dy, recomputing the forward from h:
    (dh, dw_qkv [3E, D], db_qkv, dw_out [D, E], db_out), all fp32, E the
    attention's width (D, or a tensor-parallel part of it).  h and g
    hold values of the operand dtype `dt`; operands are rounded to it where
    the TPU kernels round (qkv, scaled q, probs, attn_out, dattn,
    dlogits·scale, dqkv) and multiplied in fp32; db_qkv sums the unrounded
    dqkv."""
    D, E = h.shape[-1], w_out.shape[1]   # E < D: a tensor-parallel part

    def rnd(t):
        return t.to(dt).float()

    h = h.float()
    wq, wo = rnd(w_qkv), rnd(w_out)
    qkv = (h @ wq.T + b_qkv.float()).to(dt)
    g32 = g.float()
    g16 = rnd(g32)
    g3 = rnd(g16 @ wo)                                       # dattn
    attn, dqkv = attention_core(qkv, n_head, bias, g3)
    dw_out = g16.reshape(-1, D).T @ attn.reshape(-1, E)
    db_out = g32.reshape(-1, D).sum(dim=0)
    dqkv16 = rnd(dqkv)
    dh = dqkv16 @ wq
    dw_qkv = dqkv16.reshape(-1, 3 * E).T @ h.reshape(-1, D)
    db_qkv = dqkv.reshape(-1, 3 * E).sum(dim=0)
    return dh, dw_qkv, db_qkv, dw_out, db_out


def ln_attention_residual_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                                    n_head: int, g, bias=None):
    """The backward kernel's plain version: from g = dy [N, L, D] in x's
    dtype, (dx in x's dtype; dln_w, dln_b, dw_qkv [3D, D], db_qkv, dw_out
    [D, D], db_out in fp32).  Recomputes the forward from x.  Operands are
    rounded to x's dtype where the TPU kernel rounds (h, qkv, scaled q,
    probs, attn_out, g, dattn, dlogits·scale, dqkv) and multiplied in fp32;
    db_qkv sums the unrounded dqkv, dLN and dx come from the fp32 dh.  With
    an fp32 x nothing is rounded and this is the exact gradient."""
    dt = x.dtype
    D = x.shape[-1]
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    h = (xhat * ln_w.float() + ln_b.float()).to(dt)
    dh, dw_qkv, db_qkv, dw_out, db_out = _mha_bwd(h, w_qkv, b_qkv, w_out,
                                                  n_head, g, bias, dt)
    g32 = g.float()

    dln_w = (dh * xhat).reshape(-1, D).sum(dim=0)
    dln_b = dh.reshape(-1, D).sum(dim=0)
    gdh = dh * ln_w.float()
    dx = g32 + rstd * (gdh - gdh.mean(dim=-1, keepdim=True)
                       - xhat * (gdh * xhat).mean(dim=-1, keepdim=True))
    return dx.to(dt), dln_w, dln_b, dw_qkv, db_qkv, dw_out, db_out


# the C entries' argument lists: K1/K3 take the LN parameters and eps,
# K10/K11 neither
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_void_p])
_K10_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                 + [ctypes.c_float] + [ctypes.c_void_p])
_K11_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
_GEMM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_CORE_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
# the most rows the kernels' grids take (65535 tiles of 128 rows)
MAX_ROWS = 65535 * 128


@functools.lru_cache(maxsize=256)
def _workspace(lib: str, N: int, L: int, D: int, H: int, ln: bool) -> int:
    """Bytes of scratch one call of library `lib` (the forward's or the
    backward's source) takes at this shape, as its C side carves it."""
    fn = _build.function(lib, f"{lib}_workspace", [ctypes.c_int] * 5,
                         restype=ctypes.c_size_t)
    return fn(N, L, D, H, int(ln))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda_args(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, n_head, bias):
    """What the kernels take: bf16 activations and weights, fp32 LN params
    (None for K10/K11) and biases, contiguous, head dim 64, L <= 64.  K10/K11
    also take n_head heads that are a part of the model's (tensor
    parallelism): E = 64·n_head, w_qkv [3E, D], w_out [D, E], D a multiple
    of 64.  Anything else raises."""
    if x.dim() != 3:
        raise ValueError(f"activations must be [N, L, D], got "
                         f"{tuple(x.shape)}")
    N, L, D = x.shape
    E = w_qkv.shape[0] // 3           # the attention's width
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"the attention-sublayer kernel computes in bfloat16; got {x.dtype}"
            " activations on CUDA (compute_dtype='float32' has no CUDA kernel "
            "in this port yet — use compute_dtype='bfloat16')")
    whole = ln_w is not None        # K1/K3: the residual needs D == E
    if E != 64 * n_head or (D != E if whole else D % 64) or L > 64:
        raise ValueError(f"attention-sublayer kernel takes head dim 64 and "
                         f"L <= 64; got D={D}, heads={n_head}, L={L}")
    if N * L > MAX_ROWS:
        raise ValueError(f"attention-sublayer kernel takes at most "
                         f"{MAX_ROWS} rows; got N·L = {N * L}")
    dev = x.device
    f32, b16 = torch.float32, torch.bfloat16
    for name, t, dtype, shape in (
            ("x", x, b16, (N, L, D)), ("ln_w", ln_w, f32, (D,)),
            ("ln_b", ln_b, f32, (D,)), ("w_qkv", w_qkv, b16, (3 * E, D)),
            ("b_qkv", b_qkv, f32, (3 * E,)), ("w_out", w_out, b16, (D, E)),
            ("b_out", b_out, f32, (D,))):
        if t is not None or name not in ("ln_w", "ln_b"):
            _check(name, t, dtype, shape, dev)
    if bias is not None:
        _check("bias", bias, f32, (N, L, L), dev)


def _launch_fwd(entry: str, argtypes, x, ln, w_qkv, b_qkv, w_out, b_out,
                n_head: int, bias) -> torch.Tensor:
    """One call of a forward C entry of csrc/ln_attention_residual.cu on
    checked arguments; ln: (ln_w, ln_b), or None for K10."""
    N, L, D = x.shape
    P = _build.ptr
    lib = "ln_attention_residual"
    work = torch.empty(_workspace(lib, N, L, D, n_head, ln is not None),
                       dtype=torch.uint8, device=x.device)
    y = torch.empty_like(x)
    ln_args = [P(ln[0]), P(ln[1])] if ln is not None else []
    eps = [LN_EPS] if ln is not None else []
    fn = _build.function(lib, entry, argtypes)
    with torch.cuda.device(x.device):
        err = fn(P(x), None if bias is None else P(bias), *ln_args,
                 P(w_qkv), P(b_qkv), P(w_out), P(b_out), P(work), P(y),
                 N, L, D, n_head, *eps, _build.stream())
    _build.check(err, entry)
    return y


def ln_attention_residual(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                          n_head: int, bias=None) -> torch.Tensor:
    """x [N, L, D]; LN params [D]; w_qkv [3D, D], b_qkv [3D]; w_out [D, D],
    b_out [D]; bias [N, L, L] fp32 or None.  Returns [N, L, D] in x's dtype.

    On CUDA: x and both weights bf16, LN params and biases fp32, all
    contiguous; head dim 64 and L <= 64.  Anything else raises."""
    if not x.is_cuda:
        return ln_attention_residual_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                           w_out, b_out, n_head, bias)
    _check_cuda_args(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, n_head, bias)
    y = _launch_fwd("ln_attention_residual_fwd", _ARGTYPES, x, (ln_w, ln_b),
                    w_qkv, b_qkv, w_out, b_out, n_head, bias)
    ln_attention_residual.launches += 1
    return y


ln_attention_residual.launches = 0


def _launch_bwd(entry: str, argtypes, x, ln, w_qkv, b_qkv, w_out, n_head: int,
                g, bias):
    """One call of a backward C entry of csrc/ln_attention_residual_bwd.cu
    on checked arguments → (dx, dln [3, D], dw_qkv, db_qkv, dw_out); ln:
    (ln_w, ln_b), or None for K11 (dln's rows 0 and 1 then stay zero)."""
    N, L, D = x.shape
    E = 64 * n_head
    dev = x.device
    _check("g", g, torch.bfloat16, (N, L, D), dev)
    lib = "ln_attention_residual_bwd"
    f32 = torch.float32
    work = torch.empty(_workspace(lib, N, L, D, n_head, ln is not None),
                       dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dln = torch.empty((3, D), dtype=f32, device=dev)
    dw_qkv = torch.empty((3 * E, D), dtype=f32, device=dev)
    db_qkv = torch.empty(3 * E, dtype=f32, device=dev)
    dw_out = torch.empty((D, E), dtype=f32, device=dev)
    P = _build.ptr
    ln_args = [P(ln[0]), P(ln[1])] if ln is not None else []
    eps = [LN_EPS] if ln is not None else []
    fn = _build.function(lib, entry, argtypes)
    with torch.cuda.device(dev):
        err = fn(P(x), None if bias is None else P(bias), *ln_args,
                 P(w_qkv), P(b_qkv), P(w_out), P(g), P(work), P(dx), P(dln),
                 P(dw_qkv), P(db_qkv), P(dw_out), N, L, D, n_head, *eps,
                 _build.stream())
    _build.check(err, entry)
    return dx, dln, dw_qkv, db_qkv, dw_out


def ln_attention_residual_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                              n_head: int, g, bias=None):
    """Backward of `ln_attention_residual`: the forward's inputs and g = dy
    [N, L, D] → (dx, dln_w, dln_b, dw_qkv, db_qkv, dw_out, db_out), dx in
    x's dtype and the rest fp32.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel under the forward's conditions (g bf16
    and contiguous).  Sums over rows are taken in a fixed order, so two
    calls give the same bits."""
    if not x.is_cuda:
        return ln_attention_residual_bwd_plain(
            x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, n_head, g, bias)
    _check_cuda_args(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, n_head, bias)
    dx, dln, dw_qkv, db_qkv, dw_out = _launch_bwd(
        "ln_attention_residual_bwd", _BWD_ARGTYPES, x, (ln_w, ln_b), w_qkv,
        b_qkv, w_out, n_head, g, bias)
    ln_attention_residual_bwd.launches += 1
    return dx, dln[0], dln[1], dw_qkv, db_qkv, dw_out, dln[2]


ln_attention_residual_bwd.launches = 0


# ---------------------------------------------------------------------------
# K10/K11: the sublayer without LayerNorm and residual
# ---------------------------------------------------------------------------

def attention_sublayer_plain(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
                             bias=None) -> torch.Tensor:
    """K10's plain version: y = W_o · MHA(h · W_qkv + b_qkv) + b_o on a
    pre-normalised h [N, L, D], in h's dtype.  Rounds to h's dtype at the
    TPU kernel's rounding points and multiplies in fp32 (`mha`), so with an
    fp32 h it is the einsum composition."""
    return mha(h, w_qkv, b_qkv, w_out, b_out, n_head, bias).to(h.dtype)


def attention_sublayer_bwd_plain(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
                                 g, bias=None):
    """K11's plain version: from g = dy [N, L, D] in h's dtype, (dh in h's
    dtype; dw_qkv [3D, D], db_qkv, dw_out [D, D], db_out in fp32), written
    out by hand with the TPU kernel's rounding points (`_mha_bwd`); the
    exact gradient for an fp32 h."""
    dh, dw_qkv, db_qkv, dw_out, db_out = _mha_bwd(h, w_qkv, b_qkv, w_out,
                                                  n_head, g, bias, h.dtype)
    return dh.to(h.dtype), dw_qkv, db_qkv, dw_out, db_out


def attention_sublayer(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
                       bias=None) -> torch.Tensor:
    """K10: h [N, L, D]; w_qkv [3E, D], b_qkv [3E]; w_out [D, E], b_out [D];
    bias [N, L, L] fp32 or None → y [N, L, D] in h's dtype, E = 64·n_head
    (D, or the part of the heads a tensor-parallel rank holds).  A CPU
    tensor takes the plain version.  On CUDA: h and both weights bf16,
    biases fp32, all contiguous; head dim 64 and L <= 64.  Anything else
    raises."""
    if not h.is_cuda:
        return attention_sublayer_plain(h, w_qkv, b_qkv, w_out, b_out, n_head,
                                        bias)
    _check_cuda_args(h, None, None, w_qkv, b_qkv, w_out, b_out, n_head, bias)
    y = _launch_fwd("attention_sublayer_fwd", _K10_ARGTYPES, h, None, w_qkv,
                    b_qkv, w_out, b_out, n_head, bias)
    attention_sublayer.launches += 1
    return y


attention_sublayer.launches = 0


def attention_sublayer_bwd(h, w_qkv, b_qkv, w_out, b_out, n_head: int, g,
                           bias=None):
    """K11, the backward of `attention_sublayer`: the forward's inputs and
    g = dy [N, L, D] → (dh in h's dtype; dw_qkv, db_qkv, dw_out, db_out in
    fp32).  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel under the forward's conditions (g bf16 and contiguous).  Sums
    over rows are taken in a fixed order, so two calls give the same
    bits."""
    if not h.is_cuda:
        return attention_sublayer_bwd_plain(h, w_qkv, b_qkv, w_out, b_out,
                                            n_head, g, bias)
    _check_cuda_args(h, None, None, w_qkv, b_qkv, w_out, b_out, n_head, bias)
    dh, dln, dw_qkv, db_qkv, dw_out = _launch_bwd(
        "attention_sublayer_bwd", _K11_ARGTYPES, h, None, w_qkv, b_qkv, w_out,
        n_head, g, bias)
    attention_sublayer_bwd.launches += 1
    return dh, dw_qkv, db_qkv, dw_out, dln[2]


attention_sublayer_bwd.launches = 0


# ---------------------------------------------------------------------------
# The kernels' stages one by one (csrc/sublayer.cuh), each with its plain
# version: what the tests hold the CUDA stages to, and, composed, what they
# hold to the whole-function plain versions above and to the TPU kernels
# ---------------------------------------------------------------------------

# the sublayer's products by epilogue and operand orientation (C entry
# sublayer_gemm's `kind`): a [R, K] or, MN-major, [K, R]; b [C, K] (torch's
# weight layout) or [K, C]
GEMM_KINDS = {
    "bias": 0,             # a [R, K] · b [C, K]ᵀ + bias → bf16 (qkv; K10's y)
    "bias_residual": 1,    # the same + res [R, C] in fp32 → bf16 (K1's y)
    "bf16": 2,             # a [R, K] · b [K, C] → bf16 (dattn; K11's dh)
    "fp32": 3,             # the same → fp32 (K3's dh)
    "weight_grad": 4,      # a [K, R]ᵀ · b [K, C] → fp32, K split into ranges
}


def sublayer_gemm_plain(a, b, kind: str, bias=None, res=None,
                        splits: int = 1) -> torch.Tensor:
    """The GEMM stage's plain version: fp32 products of the operands'
    values, the bias and residual added in fp32 in that order, rounded
    once to bf16 (kinds "bias", "bias_residual", "bf16") or kept fp32.
    "weight_grad" takes the K rows in `splits` ranges of a multiple of 64
    rows each and adds the ranges' products in order, as the kernel adds its
    fp32 copies."""
    a32, b32 = a.float(), b.float()
    if kind in ("bias", "bias_residual"):
        y = a32 @ b32.T + bias.float()
        if kind == "bias_residual":
            y = y + res.float()
        return y.to(torch.bfloat16)
    if kind in ("bf16", "fp32"):
        y = a32 @ b32
        return y.to(torch.bfloat16) if kind == "bf16" else y
    if kind != "weight_grad":
        raise ValueError(f"unknown GEMM kind {kind!r}")
    K = a.shape[0]
    step = -(-K // (64 * splits)) * 64
    y = None
    for k0 in range(0, K, step):
        part = a32[k0:k0 + step].T @ b32[k0:k0 + step]
        y = part if y is None else y + part
    return y


def sublayer_gemm(a, b, kind: str, bias=None, res=None) -> torch.Tensor:
    """The GEMM stage alone (csrc/ln_attention_residual.cu's sublayer_gemm):
    a CPU tensor takes the plain version; on CUDA bf16 contiguous operands
    with their widths multiples of 64, bias fp32 [C], res bf16 [R, C]."""
    if not a.is_cuda:
        return sublayer_gemm_plain(a, b, kind, bias, res)
    code = GEMM_KINDS[kind]
    R = a.shape[1] if kind == "weight_grad" else a.shape[0]
    K = a.shape[0] if kind == "weight_grad" else a.shape[1]
    C = b.shape[0] if kind in ("bias", "bias_residual") else b.shape[1]
    for name, t in (("a", a), ("b", b), ("res", res)):
        if t is not None:
            _check(name, t, torch.bfloat16, t.shape, a.device)
    if bias is not None:
        _check("bias", bias, torch.float32, (C,), a.device)
    out_dtype = torch.float32 if code >= 3 else torch.bfloat16
    out = torch.empty((R, C), dtype=out_dtype, device=a.device)
    # room for the kernel's at most 8 (MAX_SPLITS) range copies of C
    part = (torch.empty((8, R, C), dtype=torch.float32, device=a.device)
            if kind == "weight_grad" else None)
    P = _build.ptr
    fn = _build.function("ln_attention_residual", "sublayer_gemm",
                         _GEMM_ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(P(a), P(b), P(out), None if bias is None else P(bias),
                 None if res is None else P(res),
                 None if part is None else P(part), R, C, K, code,
                 _build.stream())
    _build.check(err, "sublayer_gemm")
    return out


def attention_core_bwd_plain(qkv, n_head: int, g, bias=None):
    """The attention-backward stage's plain version: qkv [N, L, 3D] and
    g = dattn [N, L, D] in the operand dtype → (dqkv in that dtype, each
    sequence's column sums of the unrounded dqkv [N, 3D] fp32: the summands
    of db_qkv, which the TPU kernel sums before rounding)."""
    dqkv = attention_core(qkv, n_head, bias, g)[1]
    return dqkv.to(qkv.dtype), dqkv.sum(dim=1)


def attention_core_bwd(qkv, n_head: int, g, bias=None):
    """The attention-backward stage alone (K9's kernels with their column
    sums, csrc/ln_attention_residual_bwd.cu's sublayer_core_bwd) on L <=
    64; a CPU tensor takes the plain version.  The forward's out and lse it
    takes come from K8 (one frame_attention launch)."""
    if not qkv.is_cuda:
        return attention_core_bwd_plain(qkv, n_head, g, bias)
    from .attention import frame_attention
    N, L, D3 = qkv.shape
    D = D3 // 3
    if L > 64:
        raise ValueError(f"the sublayer's attention stage takes L <= 64; "
                         f"got {L}")
    out, lse = frame_attention(qkv, n_head, bias, return_lse=True)
    f32 = torch.float32
    stats = torch.empty((N, n_head, 3, L), dtype=f32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((N, 3 * D), dtype=f32, device=qkv.device)
    P = _build.ptr
    fn = _build.function("ln_attention_residual_bwd", "sublayer_core_bwd",
                         _CORE_BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        err = fn(P(qkv), None if bias is None else P(bias), P(g), P(out),
                 P(lse), P(stats), P(dqkv), P(part), N, L, D, n_head,
                 _build.stream())
    _build.check(err, "sublayer_core_bwd")
    return dqkv, part


def ln_bwd_rows_plain(x, ln_w, dh, g):
    """The LayerNorm-backward rows stage's plain version: x and g in the
    operand dtype, dh fp32 → (dx in x's dtype; dln_w, dln_b, db_o fp32),
    dx = g + the LayerNorm's backward of dh."""
    D = x.shape[-1]
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    gdh = dh * ln_w.float()
    dx = g.float() + rstd * (gdh - gdh.mean(dim=-1, keepdim=True)
                             - xhat * (gdh * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype), (dh * xhat).reshape(-1, D).sum(dim=0),
            dh.reshape(-1, D).sum(dim=0), g.float().reshape(-1, D).sum(dim=0))


def sublayer_fwd_stages_plain(x, ln, w_qkv, b_qkv, w_out, b_out, n_head: int,
                              bias=None) -> torch.Tensor:
    """The forward kernels' stages composed, each through its plain
    version: h16 = LN(x) (ln: (ln_w, ln_b), K1; None: K10, h = x), qkv,
    the attention core, y (+ x) → y bf16."""
    N, L, D = x.shape
    h = x if ln is None else layer_norm(x.float(), *ln).to(x.dtype)
    qkv = sublayer_gemm_plain(h.reshape(-1, D), w_qkv, "bias", b_qkv)
    attn = attention_core(qkv.reshape(N, L, 3 * D), n_head, bias)[0]
    y = sublayer_gemm_plain(attn.reshape(-1, D), w_out,
                            "bias" if ln is None else "bias_residual", b_out,
                            x.reshape(-1, D))
    return y.reshape(N, L, D)


def sublayer_bwd_stages_plain(x, ln, w_qkv, b_qkv, w_out, n_head: int, g,
                              bias=None, splits: int = 1):
    """The backward kernel's stages composed, each through its plain
    version (ln as in `sublayer_fwd_stages_plain`) → (dx; dln_w, dln_b
    (None for K11), dw_qkv, db_qkv, dw_out, db_out), the weight gradients
    over `splits` ranges of rows, db_qkv the ordered sum of the per-sequence
    column sums."""
    N, L, D = x.shape
    M = N * L
    h = x if ln is None else layer_norm(x.float(), *ln).to(x.dtype)
    h2, g2 = h.reshape(M, D), g.reshape(M, D)
    qkv = sublayer_gemm_plain(h2, w_qkv, "bias", b_qkv).reshape(N, L, 3 * D)
    attn = attention_core(qkv, n_head, bias)[0].to(x.dtype)
    dattn = sublayer_gemm_plain(g2, w_out, "bf16")
    dqkv, part_db = attention_core_bwd_plain(qkv, n_head,
                                             dattn.reshape(N, L, D), bias)
    dqkv = dqkv.reshape(M, 3 * D)
    dh = sublayer_gemm_plain(dqkv, w_qkv, "fp32")
    if ln is None:
        dx, dln_w, dln_b = dh.to(x.dtype), None, None
        db_out = g2.float().sum(dim=0)
    else:
        dx, dln_w, dln_b, db_out = ln_bwd_rows_plain(
            x, ln[0], dh.reshape(N, L, D), g)
    dw_qkv = sublayer_gemm_plain(dqkv, h2, "weight_grad", splits=splits)
    dw_out = sublayer_gemm_plain(g2, attn.reshape(M, D), "weight_grad",
                                 splits=splits)
    return (dx.reshape(N, L, D), dln_w, dln_b, dw_qkv, part_db.sum(dim=0),
            dw_out, db_out)


class _Sublayer(torch.autograd.Function):
    """Forward and backward of a sublayer as one autograd node, through the
    kernels or their plain versions (`route`: (forward, backward)).  Saves
    its inputs only.  Gradients come back in each input's dtype (a bf16
    weight copy gets a bf16-rounded gradient, as in the JAX package, where
    the cast sits outside the custom VJP); the bias gets none."""

    @staticmethod
    def forward(ctx, route, n_head, bias, *args):
        ctx.save_for_backward(bias, *args)
        ctx.route, ctx.n_head = route, n_head
        return route[0](*args, n_head, bias)

    @staticmethod
    def backward(ctx, g):
        bias, *args = ctx.saved_tensors
        grads = ctx.route[1](*args, ctx.n_head, g.contiguous(), bias)
        return (None, None, None,
                *(gr.to(a.dtype) for gr, a in zip(grads, args)))


def ln_attention_sublayer(x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out,
                          n_head: int, bias=None,
                          kernels: bool = True) -> torch.Tensor:
    """y = x + Attn(LN(x)), differentiable in everything but the bias.
    `kernels=True`: the CUDA kernels on a CUDA tensor, the plain versions
    on a CPU tensor.  `kernels=False`: the plain versions on any device."""
    route = ((ln_attention_residual, ln_attention_residual_bwd) if kernels
             else (ln_attention_residual_plain,
                   ln_attention_residual_bwd_plain))
    return _Sublayer.apply(route, n_head, bias, x, ln_w, ln_b, w_qkv, b_qkv,
                           w_out, b_out)


def fused_attention_sublayer(h, w_qkv, b_qkv, w_out, b_out, n_head: int,
                             bias=None, kernels: bool = True) -> torch.Tensor:
    """The whole attention sublayer on a pre-normalised h, without residual
    (↔ neighborretr_tpu/ops/pallas_block_attention.py::
    fused_attention_sublayer), differentiable in everything but the bias.

    h [N, L, D] of any float dtype is computed in bf16; w_qkv [3D, D]
    (in_proj_weight) and w_out [D, D] (out_proj.weight) are cast to bf16,
    b_qkv [3D] and b_out [D] used in fp32; bias broadcastable to [N, L, L]
    fp32 or None.  y is stored as bf16 and returned in h's dtype; gradients
    come back in each input's dtype, a weight's rounded to bf16 as the JAX
    wrapper's casts make it.  `kernels=True`: K10/K11 on a CUDA tensor, the
    plain versions on a CPU tensor; `kernels=False`: the plain versions."""
    N, L, D = h.shape
    if bias is not None:
        bias = bias.float().expand(N, L, L).contiguous()
    route = ((attention_sublayer, attention_sublayer_bwd) if kernels
             else (attention_sublayer_plain, attention_sublayer_bwd_plain))
    b16 = torch.bfloat16
    y = _Sublayer.apply(route, n_head, bias, h.to(b16).contiguous(),
                        w_qkv.to(b16).contiguous(),
                        b_qkv.float().contiguous(),
                        w_out.to(b16).contiguous(),
                        b_out.float().contiguous())
    return y.to(h.dtype)
