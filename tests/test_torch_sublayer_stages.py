"""The attention sublayer's kernel stages (csrc/sublayer.cuh) through their
plain versions, against the whole-function plain versions and the JAX
package's TPU kernels.

The CUDA sublayer runs as stages over all N·L rows: LayerNorm rows, the
GEMM with its epilogues (bias; bias + residual; bf16 or fp32 out; the
weight gradients split over the rows and added in range order), the
attention core and its backward with fp32 column sums per sequence, and
the LayerNorm-backward rows.  Here:

  * each stage's plain version on its own (shapes, dtypes, its arithmetic
    against a float64 product);
  * the plain stages composed against today's whole-function plain
    versions: bit-equal where the same torch ops run in the same order,
    otherwise within fp32 round-off, with the reason at each such check;
  * the composition against `fused_ln_attention_residual` and
    `fused_attention_sublayer` in interpret mode and their VJPs, within
    two bf16 steps (the LN variant's six summed gradients as
    test_torch_train_ops.py holds the plain K3 to the same kernel), at L in
    {1, 12, 24, 50, 64}, with and without a bias, N·L not a multiple of 64
    wherever L allows.

Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The CUDA stages are held to these plain versions in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.ops.pallas_block_attention import (
    fused_attention_sublayer as jax_sublayer, fused_ln_attention_residual)
from neighborretr_tpu_torch.ops import block_attention as BA
from test_torch_sublayer import BF16_TOL, D, H, jax_weights, sublayer_case

b16 = torch.bfloat16


def case(seed, N, L, bias_kind):
    """bf16-valued numpy inputs (x, LN params, weights, biases, g, bias):
    both frameworks then see the same operands."""
    (x, w_qkv, b_qkv, w_out, b_out, g), bias = sublayer_case(seed, N, L,
                                                             bias_kind)
    rng = np.random.default_rng(seed + 1)
    ln_w = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)

    def bf(a):
        return torch.as_tensor(a).to(b16).float().numpy()

    return (bf(x), ln_w, ln_b, bf(w_qkv), b_qkv, bf(w_out), b_out,
            bf(g)), bias


def port(arrs, bias):
    """numpy → the kernels' dtypes: activations and weights bf16, the rest
    fp32."""
    x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, g = (torch.as_tensor(a)
                                                    for a in arrs)
    return ((x.to(b16), ln_w, ln_b, w_qkv.to(b16), b_qkv, w_out.to(b16),
             b_out, g.to(b16)), None if bias is None else torch.as_tensor(bias))


def close_in_fp32(got, want, what):
    """Equal up to fp32 summation order: the bound is a few fp32 ulps of
    the tensor's largest entry (a sum's rounding scales with its terms, not
    with the result, which may cancel to near zero)."""
    want = want.double()
    tol = 1e-6 * max(want.abs().max().item(), 1.0)
    err = (got.double() - want).abs().max().item()
    assert err <= tol, (what, err, tol)


# ---------------------------------------------------------------------------
# the stages alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 50, 131])
@pytest.mark.parametrize("kind", list(BA.GEMM_KINDS))
def test_gemm_plain_is_its_product(kind, M):
    """Each epilogue and orientation: the fp32 product of the operands'
    values (float64 here), bias and residual added, rounded once to bf16
    or kept fp32; the shapes and dtypes the kernel writes."""
    rng = np.random.default_rng(M)
    K, C = 128, 192
    A = torch.as_tensor(rng.standard_normal((K, M) if kind == "weight_grad"
                                            else (M, K)), dtype=b16)
    B = torch.as_tensor(rng.standard_normal((C, K) if kind.startswith("bias")
                                            else (K, C)), dtype=b16)
    bias = torch.as_tensor(rng.standard_normal(C), dtype=torch.float32)
    res = torch.as_tensor(rng.standard_normal((M, C)), dtype=b16)
    got = BA.sublayer_gemm_plain(A, B, kind, bias, res)
    a64, b64 = A.double(), B.double()
    if kind.startswith("bias"):
        want = a64 @ b64.T + bias.double()
        if kind == "bias_residual":
            want = want + res.double()
    else:
        want = a64.T @ b64 if kind == "weight_grad" else a64 @ b64
    out_dtype = b16 if kind in ("bias", "bias_residual", "bf16") else \
        torch.float32
    assert got.dtype == out_dtype and got.shape == (M, C)
    if out_dtype == b16:
        # one bf16 rounding of an fp32 sum, whose own rounding is a few
        # fp32 ulps of its terms (an entry that cancels to near zero)
        torch.testing.assert_close(got.double(), want,
                                   atol=1e-6 * want.abs().max().item(),
                                   rtol=2 ** -8)
    else:
        close_in_fp32(got, want, kind)


@pytest.mark.parametrize("splits", [2, 3, 7])
def test_weight_grad_splits_are_ranges_added_in_order(splits):
    """K split into ranges of whole 64-row slices, each range's product in
    fp32, the ranges added in ascending order: within fp32 round-off of one
    product (a different summation order), and exactly the explicit sum."""
    rng = np.random.default_rng(splits)
    K = 64 * 9 + 13                      # ragged: the last range is short
    a = torch.as_tensor(rng.standard_normal((K, 64)), dtype=b16)
    b = torch.as_tensor(rng.standard_normal((K, 128)), dtype=b16)
    got = BA.sublayer_gemm_plain(a, b, "weight_grad", splits=splits)
    close_in_fp32(got, a.float().T @ b.float(), "split vs one product")
    step = -(-K // (64 * splits)) * 64
    assert step % 64 == 0
    want = sum((a[k:k + step].float().T @ b[k:k + step].float()
                for k in range(0, K, step)), torch.zeros(64, 128))
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,L,bias_kind", [(3, 1, None), (3, 24, "causal"),
                                           (5, 50, None), (2, 64, "keypad")])
def test_core_bwd_plain_column_sums(N, L, bias_kind):
    """dqkv as the plain attention backward rounds it; the column sums are
    each sequence's sums of the UNROUNDED dqkv (what db_qkv adds up)."""
    (x, *_, g), bias = case(N * L, N, L, bias_kind)
    qkv = torch.as_tensor(np.random.default_rng(L).standard_normal(
        (N, L, 3 * D)), dtype=b16)
    gt = torch.as_tensor(g).to(b16)
    tb = None if bias is None else torch.as_tensor(bias)
    dqkv, part = BA.attention_core_bwd_plain(qkv, H, gt, tb)
    from neighborretr_tpu_torch.ops import attention as A
    assert torch.equal(dqkv, A.attention_bwd_plain(qkv, H, gt, tb))
    assert part.dtype == torch.float32 and part.shape == (N, 3 * D)
    full = A.attention_core(qkv, H, tb, gt)[1]
    assert torch.equal(part, full.sum(dim=1))
    # the rounded rows would sum to something else in general
    assert not torch.equal(part, dqkv.float().sum(dim=1)) or L == 1


def test_stage_wrappers_on_cpu_are_the_plain_versions():
    (x, *_, g), bias = case(9, 2, 24, "causal")
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal((48, 128)), dtype=b16)
    w = torch.as_tensor(rng.standard_normal((192, 128)), dtype=b16)
    bias_c = torch.as_tensor(rng.standard_normal(192), dtype=torch.float32)
    assert torch.equal(BA.sublayer_gemm(a, w, "bias", bias_c),
                       BA.sublayer_gemm_plain(a, w, "bias", bias_c))
    qkv = torch.as_tensor(rng.standard_normal((2, 24, 3 * D)), dtype=b16)
    gt, tb = torch.as_tensor(g).to(b16), torch.as_tensor(bias)
    for p, q in zip(BA.attention_core_bwd(qkv, H, gt, tb),
                    BA.attention_core_bwd_plain(qkv, H, gt, tb)):
        assert torch.equal(p, q)


def test_more_rows_than_the_grids_take_raise():
    """N·L past 65535 tiles of 128 rows: the argument check refuses it
    (run on CPU tensors: it only reads shapes)."""
    N = BA.MAX_ROWS // 64 + 1
    x = torch.zeros(N, 64, D, dtype=b16).expand(N, 64, D)
    with pytest.raises(ValueError, match="rows"):
        BA._check_cuda_args(x, None, None, torch.zeros(3 * D, D, dtype=b16),
                            torch.zeros(3 * D), torch.zeros(D, D, dtype=b16),
                            torch.zeros(D), H, None)


# ---------------------------------------------------------------------------
# the stages composed, against the whole-function plain versions
# ---------------------------------------------------------------------------

COMPOSED = [(3, 1, None), (3, 12, "keypad"), (4, 24, "causal"),
            (3, 50, None), (2, 64, "causal")]


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("N,L,bias_kind", COMPOSED)
def test_forward_stages_are_the_plain_forward(N, L, bias_kind, ln):
    """The same torch ops in the same order (LN, qkv, attention core,
    output projection + bias (+ residual) in fp32, one rounding):
    bit-equal."""
    (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, _), bias = port(
        *case(N + L, N, L, bias_kind))
    got = BA.sublayer_fwd_stages_plain(
        x, (ln_w, ln_b) if ln else None, w_qkv, b_qkv, w_out, b_out, H, bias)
    want = (BA.ln_attention_residual_plain(x, ln_w, ln_b, w_qkv, b_qkv,
                                           w_out, b_out, H, bias) if ln else
            BA.attention_sublayer_plain(x, w_qkv, b_qkv, w_out, b_out, H,
                                        bias))
    assert got.dtype == want.dtype == b16
    assert torch.equal(got, want)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("N,L,bias_kind", COMPOSED)
def test_backward_stages_are_the_plain_backward(N, L, bias_kind, ln, splits):
    """dx (and, with LN, dln_w, dln_b), db_out, and with one range the
    weight gradients: the same ops in the same order, bit-equal.  db_qkv
    adds per-sequence column sums, and the weight gradients over several
    ranges add range products: other summation orders, so within fp32
    round-off."""
    (x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, g), bias = port(
        *case(2 * N + L, N, L, bias_kind))
    got = BA.sublayer_bwd_stages_plain(
        x, (ln_w, ln_b) if ln else None, w_qkv, b_qkv, w_out, H, g, bias,
        splits=splits)
    if ln:
        want = BA.ln_attention_residual_bwd_plain(
            x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, H, g, bias)
        names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out",
                 "db_out")
    else:
        want = BA.attention_sublayer_bwd_plain(x, w_qkv, b_qkv, w_out, b_out,
                                               H, g, bias)
        got = (got[0],) + got[3:]
        names = ("dh", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "db_qkv" or (splits > 1 and name.startswith("dw")):
            close_in_fp32(a, b, name)
        else:
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the stages composed, against the TPU kernels in interpret mode
# ---------------------------------------------------------------------------

# N·L not a multiple of 64 wherever L allows it (L = 64: any N gives one)
TPU_CASES = [(5, 1, None), (3, 12, None), (3, 12, "keypad"), (3, 24, None),
             (3, 24, "causal"), (3, 50, None), (3, 50, "keypad"),
             (2, 64, None), (2, 64, "causal")]


def assert_bf16_close(got, want, names, summed=()):
    """Elementwise within two bf16 steps; the gradients named in `summed`
    within 2^-7 of the tensor's largest entry instead, the bound
    test_torch_train_ops.py holds the plain K3 to this TPU kernel with: the
    kernel returns them rounded to bf16, and a one-ulp flip of a bf16
    operand moves a sum by a share of its terms, not of its result."""
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        a = a.float().numpy()
        if name in summed:
            assert np.isfinite(a).all(), name
            assert np.abs(a - b).max() <= 2 ** -7 * np.abs(b).max(), name
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("N,L,bias_kind", TPU_CASES)
def test_ln_stages_match_the_tpu_kernel(N, L, bias_kind):
    """K1/K3's stages against fused_ln_attention_residual and its VJP in
    interpret mode: y and dx within two bf16 steps, the six summed
    cotangents as test_torch_train_ops.py holds the plain K3 to the same
    kernel."""
    arrs, bias = case(3 * N + L, N, L, bias_kind)
    x, ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, g = arrs
    jb = None if bias is None else jnp.asarray(bias)
    wq, bq, wo, bo = jax_weights(w_qkv, b_qkv, w_out, b_out)

    def jfn(x, lw, lb, wq, bq, wo, bo):
        return fused_ln_attention_residual(x, lw, lb, wq, bq, wo, bo, H,
                                           bias=jb, interpret=True)

    jy, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16),
                      *map(jnp.asarray, (ln_w, ln_b, wq, bq, wo, bo)))
    jg = vjp(jnp.asarray(g, jnp.bfloat16))
    want = [np.asarray(jnp.asarray(a, jnp.float32)) for a in (jy, *jg)]
    want[4], want[6] = want[4].T, want[6].T          # back to torch layouts

    (tx, tlw, tlb, twq, tbq, two, tbo, tg), tb = port(arrs, bias)
    y = BA.sublayer_fwd_stages_plain(tx, (tlw, tlb), twq, tbq, two, tbo, H,
                                     tb)
    grads = BA.sublayer_bwd_stages_plain(tx, (tlw, tlb), twq, tbq, two, H,
                                         tg, tb, splits=2)
    names = ("y", "dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out",
             "db_out")
    assert_bf16_close([y, *grads], want, names, summed=names[2:])


@pytest.mark.parametrize("N,L,bias_kind", TPU_CASES)
def test_sublayer_stages_match_the_tpu_kernel(N, L, bias_kind):
    """K10/K11's stages against fused_attention_sublayer and its VJP in
    interpret mode: y and all five cotangents within two bf16 steps."""
    arrs, bias = case(5 * N + L, N, L, bias_kind)
    h, _, _, w_qkv, b_qkv, w_out, b_out, g = arrs
    jb = None if bias is None else jnp.asarray(bias)

    def jfn(h, wq, bq, wo, bo):
        return jax_sublayer(h, wq, bq, wo, bo, H, bias=jb, interpret=True)

    jy, vjp = jax.vjp(jfn, jnp.asarray(h, jnp.bfloat16), *map(
        jnp.asarray, jax_weights(w_qkv, b_qkv, w_out, b_out)))
    jg = vjp(jnp.asarray(g, jnp.bfloat16))
    want = [np.asarray(jnp.asarray(a, jnp.float32)) for a in (jy, *jg)]
    want[2], want[4] = want[2].T, want[4].T

    (th, _, _, twq, tbq, two, tbo, tg), tb = port(arrs, bias)
    y = BA.sublayer_fwd_stages_plain(th, None, twq, tbq, two, tbo, H, tb)
    dh, _, _, *rest = BA.sublayer_bwd_stages_plain(th, None, twq, tbq, two,
                                                   H, tg, tb, splits=2)
    assert_bf16_close([y, dh, *rest], want,
                      ("y", "dh", "dw_qkv", "db_qkv", "dw_out", "db_out"))
