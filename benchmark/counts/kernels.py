"""Operations and bytes of one call of each hand-written kernel the
benchmark reads a roofline of, and the least time the card could take.

Frozen copies of the program's own bound arithmetic (its bring-up check's
`bound` and `sim_bounds`): bound = max(FLOP / peak, bytes / 3.35 TB/s),
each input read and each output written once.  Backward kernels count the
work a backward needs and no recompute: K3 16·M·D² + 8·N·L²·D (the
forward's 8·M·D² twice over its weights and inputs, the attention core's
4·N·L²·D twice), K9 8·N·L²·D.  K2's float32 form runs on the tensor cores
as three TF32 products a logit (3xTF32): its bound is 3 x FLOP at the TF32
rate; its bfloat16 form's is FLOP at the bf16 rate.

A call is (family, its integer arguments by name, whether a bias or the
residual stores were passed), as the span around the C entry records it
(`kernels.json`).
"""

from __future__ import annotations

from . import peaks

BF16, F32, U8 = 2, 4, 1


def _attn_bias(N, L, has_bias):
    return N * L * L * F32 if has_bias else 0


def k1(N, L, D, H, has_bias=False):
    """LayerNorm + attention + out projection + residual, forward."""
    M = N * L
    flop = 8 * M * D * D + 4 * N * L * L * D
    nbytes = (2 * M * D * BF16 + 2 * D * F32 + 4 * D * D * BF16
              + 4 * D * F32 + _attn_bias(N, L, has_bias))
    return flop, nbytes, peaks.BF16


def k3(N, L, D, H, has_bias=False):
    """Its backward: reads x, the weights, the bias and dy; writes dx and
    the float32 parameter gradients."""
    M = N * L
    flop = 16 * M * D * D + 8 * N * L * L * D
    nbytes = (3 * M * D * BF16 + 2 * D * F32 + 4 * D * D * BF16
              + 4 * D * F32 + _attn_bias(N, L, has_bias)
              + 2 * D * F32 + 4 * D * D * F32 + 4 * D * F32)
    return flop, nbytes, peaks.BF16


def k8(N, L, D, H, has_bias=False):
    """Attention over packed qkv, forward: reads qkv, writes out and the
    rows' log-sum-exp."""
    flop = 4 * N * L * L * D
    nbytes = (4 * N * L * D * BF16 + N * H * L * F32
              + _attn_bias(N, L, has_bias))
    return flop, nbytes, peaks.BF16


def k9(N, L, D, H, has_bias=False):
    """Its backward: reads qkv, dout, out and lse; writes dqkv."""
    flop = 8 * N * L * L * D
    nbytes = (8 * N * L * D * BF16 + N * H * L * F32
              + _attn_bias(N, L, has_bias))
    return flop, nbytes, peaks.BF16


def k2(A, B, T, V, D, saved=False, bf16=False):
    """Token-interaction similarity S [A, B] of prepared features: reads
    both sides and their weights, writes S (and, under autograd, the
    routing: two maxima in fp32 and two indices in uint8 per pair)."""
    flop = 2 * A * T * B * V * D
    feat = BF16 if bf16 else F32
    nbytes = ((A * T + B * V) * D * feat + (A * T + B * V) * F32
              + A * B * F32)
    if saved:
        nbytes += A * B * (T + V) * (F32 + U8)
    if bf16:
        return flop, nbytes, peaks.BF16
    return 3 * flop, nbytes, peaks.TF32


FAMILIES = {"K1": k1, "K3": k3, "K8": k8, "K9": k9, "K2": k2}


def bound_s(family: str, ints: dict, flags: dict) -> float:
    """The least seconds one call could take."""
    flop, nbytes, peak = FAMILIES[family](**ints, **flags)
    return max(flop / peak, nbytes / peaks.BYTES)
