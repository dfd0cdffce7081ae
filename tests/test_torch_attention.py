"""The port's packed-qkv attention (ops/attention.py) and its route through
the towers against the JAX package.

The plain versions against pallas_attention.fused_frame_attention in
interpret mode and its custom VJP, on bf16 inputs (the TPU kernels round q
and the probabilities to bf16 whatever their input's type, so fp32 inputs
cannot be held tightly against them; the fp32 mode of the plain versions is
held to an independent fp32 formula instead); a block and a tower under
`fused_attention=True` against block_apply / transformer_apply; the
autograd function; the routing rules.  Inputs come from a numpy seed and
reach both frameworks as numpy arrays.  The CUDA kernels themselves are held
to these plain versions on a card in test_torch_gpu.py.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.models import layers as JL
from neighborretr_tpu.ops.pallas_attention import \
    fused_frame_attention as jax_fused_frame_attention
from neighborretr_tpu_torch.core.config import ModelConfig
from neighborretr_tpu_torch.models import layers as PL
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.models.neighborretr import resolve_fused_attention
from neighborretr_tpu_torch.ops import attention as A
from neighborretr_tpu_torch.ops import block_attention as BA

H, HD = 2, 64          # head dim 64, as in every CLIP tower
D = H * HD

# kernel-boundary tolerance on bf16 outputs: one bf16 ulp (2^-8 relative)
# of the value, and one ulp of the tensor's typical entry for entries near
# zero, where differently ordered fp32 sums land on either side of a
# rounding boundary
BF16_ULP = 2 ** -8


def case(seed, N, L, bias_kind):
    """qkv [N, L, 3D], a cotangent [N, L, D] and the bias, as numpy."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((N, L, 3 * D)).astype(np.float32)
    g = rng.standard_normal((N, L, D)).astype(np.float32)
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        if bias_kind == "causal":      # text: causal ∧ padding, rows see
            bias = (np.asarray(JL.causal_bias(L))[:, 0]       # themselves
                    + np.asarray(JL.padding_bias(
                        (j[None] < lens[:, None]).astype(np.float32)))[:, 0])
        else:                          # temporal: key padding, -1e6
            pad = np.where(j[None] < lens[:, None], 0.0, -1e6)
            bias = np.broadcast_to(pad[:, None, :], (N, L, L))
        bias = np.ascontiguousarray(bias, np.float32)
    return qkv, g, bias


def bf16(a):
    return torch.as_tensor(a).bfloat16()


def jbf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def assert_bf16_close(got, want, what):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    atol = BF16_ULP * max(1.0, float(np.abs(want).mean()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=BF16_ULP,
                               err_msg=what)


# name, N, L, bias, NRTPU_ATTN_ROW_CHUNK on the JAX side: the single-tile
# kernels, the biased ones, and the row-chunked ones with a ragged edge
# chunk (22 = 8 + 8 + 6) and with one chunk
PALLAS_CASES = [("frames", 6, 10, None, None), ("one_frame", 1, 50, None, None),
                ("text", 6, 12, "causal", None),
                ("temporal", 4, 12, "keypad", None),
                ("rows_ragged", 3, 22, None, "8"),
                ("rows_one_chunk", 2, 24, None, "24")]


@pytest.mark.parametrize("name,N,L,bias_kind,row_chunk", PALLAS_CASES)
def test_attention_plain_matches_pallas_kernel(monkeypatch, name, N, L,
                                               bias_kind, row_chunk):
    if row_chunk:
        monkeypatch.setenv("NRTPU_ATTN_ROW_CHUNK", row_chunk)
    qkv, _, bias = case(1, N, L, bias_kind)
    want = jax_fused_frame_attention(
        jbf16(qkv), H, bias=None if bias is None else jnp.asarray(bias),
        interpret=True)
    got = A.attention_plain(bf16(qkv), H,
                            None if bias is None else torch.as_tensor(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (N, L, D)
    assert_bf16_close(got, want.astype(jnp.float32), name)


@pytest.mark.parametrize("name,N,L,bias_kind,row_chunk", PALLAS_CASES)
def test_attention_bwd_plain_matches_pallas_vjp(monkeypatch, name, N, L,
                                                bias_kind, row_chunk):
    if row_chunk:
        monkeypatch.setenv("NRTPU_ATTN_ROW_CHUNK", row_chunk)
    qkv, g, bias = case(2, N, L, bias_kind)
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda x: jax_fused_frame_attention(
        x, H, bias=jb, interpret=True), jbf16(qkv))
    (want,) = vjp(jbf16(g))
    got = A.attention_bwd_plain(
        bf16(qkv), H, bf16(g), None if bias is None else torch.as_tensor(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (N, L, 3 * D)
    assert_bf16_close(got, want.astype(jnp.float32), name)


@pytest.mark.parametrize("bias_kind", [None, "causal", "keypad"])
def test_attention_plain_fp32_is_the_exact_function_and_gradient(bias_kind):
    """With fp32 inputs nothing is rounded: forward and gradient against
    jax.grad of the textbook formula (tolerance: the JAX suite's fp32 kernel
    bound, atol 2e-5 / rtol 1e-4)."""
    N, L = 4, 12
    qkv, g, bias = case(3, N, L, bias_kind)

    def f(x):
        q, k, v = (t.reshape(N, L, H, HD) for t in jnp.split(x, 3, axis=-1))
        logits = jnp.einsum("nqhd,nkhd->nhqk", q * HD ** -0.5, k)
        if bias is not None:
            logits = logits + jnp.asarray(bias)[:, None]
        p = jax.nn.softmax(logits, axis=-1)
        return jnp.einsum("nhqk,nkhd->nqhd", p, v).reshape(N, L, D)

    want, vjp = jax.vjp(f, jnp.asarray(qkv))
    tb = None if bias is None else torch.as_tensor(bias)
    got = A.attention_plain(torch.as_tensor(qkv), H, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    dq = A.attention_bwd_plain(torch.as_tensor(qkv), H, torch.as_tensor(g), tb)
    np.testing.assert_allclose(dq.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("bias_kind", [None, "causal"])
@pytest.mark.parametrize("kernels", [True, False])
def test_autograd_function_gradient_is_the_plain_backward(bias_kind, kernels):
    """One node that saves qkv, the bias, the output and lse; its gradient is
    attention_bwd_plain's fed that output and lse (and within one bf16
    rounding of it without them), the bias gets none; on the CPU the
    wrappers take the plain versions and count no launch."""
    qkv, g, bias = case(4, 3, 10, bias_kind)
    tb = None if bias is None else torch.as_tensor(bias).requires_grad_(True)
    x = bf16(qkv).requires_grad_(True)
    before = (A.frame_attention.launches, A.frame_attention_bwd.launches)
    out = A.fused_frame_attention(x, H, tb, kernels)
    assert out.grad_fn.name().startswith("_FrameAttention")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4 and torch.equal(saved[0], x)  # qkv, bias, out, lse
    assert (saved[1] is None) == (bias is None)
    want_out, want_lse = A.attention_plain(x.detach(), H, tb, return_lse=True)
    assert torch.equal(out, want_out) and torch.equal(saved[2], want_out)
    assert saved[3].dtype == torch.float32 and torch.equal(saved[3], want_lse)
    out.backward(bf16(g))
    want = A.attention_bwd_plain(x.detach(), H, bf16(g), tb, out=want_out,
                                 lse=want_lse)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, want)
    assert_bf16_close(x.grad, A.attention_bwd_plain(
        x.detach(), H, bf16(g), tb).detach().float().numpy(),
        "without out/lse")
    assert tb is None or tb.grad is None
    assert (A.frame_attention.launches,
            A.frame_attention_bwd.launches) == before


def test_autograd_function_fp32_matches_autograd_of_the_formula():
    qkv, g, bias = case(5, 2, 9, "causal")
    x = torch.as_tensor(qkv).requires_grad_(True)
    A.fused_frame_attention(x, H, torch.as_tensor(bias)).backward(
        torch.as_tensor(g))
    y = torch.as_tensor(qkv).requires_grad_(True)
    q, k, v = (t.reshape(2, 9, H, HD).transpose(1, 2)
               for t in y.split(D, dim=-1))
    p = torch.softmax(q @ k.transpose(-1, -2) * HD ** -0.5
                      + torch.as_tensor(bias)[:, None], dim=-1)
    (p @ v).transpose(1, 2).reshape(2, 9, D).backward(torch.as_tensor(g))
    torch.testing.assert_close(x.grad, y.grad, atol=2e-5, rtol=1e-4)


def test_block_attention_plain_versions_share_the_attention_arithmetic():
    """ops/block_attention.py's mha is qkv projection → attention_plain →
    out projection, bit for bit."""
    rng = np.random.default_rng(6)
    h = bf16(rng.standard_normal((3, 10, D)))
    w_qkv = bf16(rng.standard_normal((3 * D, D)) * D ** -0.5)
    w_out = bf16(rng.standard_normal((D, D)) * D ** -0.5)
    b_qkv = torch.as_tensor(rng.standard_normal(3 * D).astype(np.float32))
    b_out = torch.as_tensor(rng.standard_normal(D).astype(np.float32))
    qkv = (h.float() @ w_qkv.float().T + b_qkv).bfloat16()
    want = A.attention_plain(qkv, H).float() @ w_out.float().T + b_out
    assert torch.equal(BA.mha(h, w_qkv, b_qkv, w_out, b_out, H), want)


# ---------------------------------------------------------------------------
# what the CUDA wrappers refuse (the checks run before any launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,make,word", [
    ("fp32 activations", lambda q, b: (q.float(), 2, b), "bfloat16"),
    ("head dim 32", lambda q, b: (q, 4, b), "head dim"),
    ("not contiguous", lambda q, b: (q.transpose(0, 1), 2, None),
     "contiguous"),
    ("bias shape", lambda q, b: (q, 2, b[:, :, :-1]), "shape"),
    ("bias dtype", lambda q, b: (q, 2, b.double()), "float32"),
    ("not packed", lambda q, b: (q[:, :, :-1], 2, None), "3D")])
def test_cuda_argument_checks_raise(what, make, word):
    qkv, _, bias = case(7, 4, 6, "causal")
    q, n_head, b = make(bf16(qkv), torch.as_tensor(bias))
    with pytest.raises(ValueError, match=word):
        A._check_cuda_args(q, n_head, b)
    A._check_cuda_args(bf16(qkv), 2, torch.as_tensor(bias))     # and passes


@pytest.mark.parametrize("what,make,word", [
    ("out dtype", lambda o, s: (o.float(), s), "bfloat16"),
    ("out shape", lambda o, s: (o[:, :-1], s), "shape"),
    ("out not contiguous",
     lambda o, s: (o.transpose(1, 2).contiguous().transpose(1, 2), s),
     "contiguous"),
    ("lse dtype", lambda o, s: (o, s.bfloat16()), "float32"),
    ("lse shape", lambda o, s: (o, s[:, :1]), "shape"),
    ("lse not contiguous",
     lambda o, s: (o, s.transpose(1, 2).contiguous().transpose(1, 2)),
     "contiguous")])
def test_cuda_argument_checks_raise_on_saved_statistics(what, make, word):
    """The backward's out [N, L, D] bf16 and lse [N, H, L] fp32 are checked
    like qkv and g."""
    qkv, g, bias = case(7, 4, 6, "causal")
    x, tb = bf16(qkv), torch.as_tensor(bias)
    out, lse = A.attention_plain(x, 2, tb, return_lse=True)
    o, s = make(out, lse)
    with pytest.raises(ValueError, match=word):
        A._check_cuda_args(x, 2, tb, bf16(g), o, s)
    A._check_cuda_args(x, 2, tb, bf16(g), out, lse)             # and passes


# ---------------------------------------------------------------------------
# the forward's log-sum-exp and the backward from the saved statistics
# ---------------------------------------------------------------------------

def plain_logits64(qkv, bias):
    """The plain versions' logits (q rounded after its scaling, fp32 bias)
    in float64 → [N, H, L, L]."""
    t = torch.as_tensor(qkv)
    N, L, _ = t.shape
    q, k, _ = (a.reshape(N, L, H, HD) for a in t.float().split(D, dim=-1))
    q = (q * HD ** -0.5).to(t.dtype).double()
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k.double())
    if bias is not None:
        logits = logits + torch.as_tensor(bias).double()[:, None]
    return logits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_kind", [None, "causal", "keypad"])
def test_plain_lse_is_the_logsumexp_of_the_logits(bias_kind, dtype):
    """lse [N, H, L] fp32 against a float64 log-sum-exp of the same logits
    (fp32 logits and sums: 1e-5 relative); out unchanged by asking for it."""
    qkv, _, bias = case(11, 3, 13, bias_kind)
    x = torch.as_tensor(qkv).to(dtype)
    tb = None if bias is None else torch.as_tensor(bias)
    out, lse = A.attention_plain(x, H, tb, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (3, H, 13)
    want = torch.logsumexp(plain_logits64(x, bias), dim=-1)
    torch.testing.assert_close(lse.double(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, A.attention_plain(x, H, tb))
    assert torch.equal(A.frame_attention(x, H, tb, return_lse=True)[1], lse)


@pytest.mark.parametrize("name,N,L,bias_kind,row_chunk", PALLAS_CASES)
def test_attention_bwd_plain_from_saved_statistics_matches_pallas_vjp(
        monkeypatch, name, N, L, bias_kind, row_chunk):
    """The plain backward fed the plain forward's out and lse against the
    plain backward without them and against the Pallas kernels' VJP in
    interpret mode, at the tolerance of the tests above."""
    if row_chunk:
        monkeypatch.setenv("NRTPU_ATTN_ROW_CHUNK", row_chunk)
    qkv, g, bias = case(12, N, L, bias_kind)
    tb = None if bias is None else torch.as_tensor(bias)
    out, lse = A.attention_plain(bf16(qkv), H, tb, return_lse=True)
    got = A.attention_bwd_plain(bf16(qkv), H, bf16(g), tb, out=out, lse=lse)
    assert got.dtype == torch.bfloat16 and got.shape == (N, L, 3 * D)
    assert_bf16_close(got, A.attention_bwd_plain(bf16(qkv), H, bf16(g),
                                                 tb).float().numpy(), name)
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda x: jax_fused_frame_attention(
        x, H, bias=jb, interpret=True), jbf16(qkv))
    (want,) = vjp(jbf16(g))
    assert_bf16_close(got, want.astype(jnp.float32), name)


@pytest.mark.parametrize("bias_kind", [None, "causal", "keypad"])
def test_attention_bwd_plain_from_saved_statistics_fp32_is_exact(bias_kind):
    """fp32 inputs: nothing is rounded, and the backward fed out and lse is
    the exact gradient (float64 autograd of the formula) to 1e-5."""
    N, L = 3, 11
    qkv, g, bias = case(13, N, L, bias_kind)
    tb = None if bias is None else torch.as_tensor(bias)
    out, lse = A.attention_plain(torch.as_tensor(qkv), H, tb, return_lse=True)
    got = A.attention_bwd_plain(torch.as_tensor(qkv), H, torch.as_tensor(g),
                                tb, out=out, lse=lse)
    x = torch.as_tensor(qkv).double().requires_grad_(True)
    q, k, v = (t.reshape(N, L, H, HD).transpose(1, 2)
               for t in x.split(D, dim=-1))
    logits = q @ k.transpose(-1, -2) * HD ** -0.5
    if tb is not None:
        logits = logits + tb.double()[:, None]
    (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(N, L, D) \
        .backward(torch.as_tensor(g).double())
    torch.testing.assert_close(got.double(), x.grad, atol=1e-5, rtol=1e-5)


def kernel_rounding(qkv, g, n_head, bias=None, tile=64):
    """The CUDA kernels' arithmetic in fp32 on the CPU, rounding points
    included.  A row that fits one key tile (L <= tile) keeps the TPU's: its
    probabilities normalised, then rounded; delta = sum_k dprobs·probs.
    Past one tile the forward walks the keys tile by tile with a running row
    max, rounds the unnormalised probabilities to bf16 for probs·V and
    divides by the row sum once at the end; the backward takes the
    probabilities from lse and delta from the bf16 out.  → (out bf16, lse,
    dqkv bf16)."""
    N, L, D3 = qkv.shape
    Dm = D3 // 3
    hd = Dm // n_head
    q, k, v = (t.reshape(N, L, n_head, hd).transpose(1, 2)
               for t in qkv.float().split(Dm, dim=-1))
    s = q @ k.transpose(-1, -2) * hd ** -0.5              # exact in bf16
    if bias is not None:
        s = s + bias.float()[:, None]
    m = torch.full((N, n_head, L), -torch.inf)
    lsum = torch.zeros(N, n_head, L)
    o = torch.zeros(N, n_head, L, hd)
    one_tile = L <= tile
    for k0 in range(0, L, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        lsum = lsum * alpha + p.sum(-1)
        if one_tile:
            p = p / lsum[..., None]
        o = o * alpha[..., None] + p.bfloat16().float() @ v[:, :, k0:k0 + tile]
        m = m_new
    if not one_tile:
        o = o / lsum[..., None]
    out = o.transpose(1, 2).reshape(N, L, Dm).bfloat16()
    lse = m + torch.log(lsum)
    p = torch.exp(s - lse[..., None])
    g3 = g.float().reshape(N, L, n_head, hd).transpose(1, 2)
    dprobs = g3 @ v.transpose(-1, -2)
    if one_tile:
        delta = (dprobs * p).sum(-1)
    else:
        delta = (g3 * out.float().reshape(N, L, n_head, hd).transpose(1, 2)
                 ).sum(-1)
    dv = p.bfloat16().float().transpose(-1, -2) @ g3
    ds = (p * (dprobs - delta[..., None]) * hd ** -0.5).bfloat16().float()
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    dqkv = torch.cat([t.transpose(1, 2).reshape(N, L, Dm)
                      for t in (dq, dk, dv)], dim=-1)
    return out, lse, dqkv.bfloat16()


@pytest.mark.parametrize("bias_kind", [None, "causal", "keypad"])
@pytest.mark.parametrize("L,tile", [(50, 64), (50, 16), (197, 64)])
def test_kernel_rounding_points_stay_inside_the_card_tolerances(L, tile,
                                                                bias_kind):
    """Evidence on the CPU for the card: the kernels' rounding points,
    emulated (one tile at L = 50; the moved points at L = 197 and, with
    16-key tiles, at L = 50), against attention_plain / attention_bwd_plain
    (the TPU's rounding) at the tolerances chip_smoke.py and
    test_torch_gpu.py hold the kernels to: out within K1_TOL (2^-6 + 2^-6
    relative), each part of dqkv within 2^-6 relative + 2^-7 of its largest
    entry, lse to 1e-4."""
    qkv, g, bias = case(14 + L, 2, L, bias_kind)
    x, gg = bf16(qkv), bf16(g)
    tb = None if bias is None else torch.as_tensor(bias)
    out, lse, dqkv = kernel_rounding(x, gg, H, tb, tile)
    want_out, want_lse = A.attention_plain(x, H, tb, return_lse=True)
    err = (out.float() - want_out.float()).abs()
    assert (err <= 2 ** -6 + 2 ** -6 * want_out.float().abs()).all(), \
        err.max().item()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    want = A.attention_bwd_plain(x, H, gg, tb)
    for part, a, b in zip(("dq", "dk", "dv"), dqkv.float().split(D, -1),
                          want.float().split(D, -1)):
        err = (a - b).abs()
        assert (err <= 2 ** -6 * b.abs() + 2 ** -7 * b.abs().max()).all(), \
            (part, err.max().item())
    if L <= tile:    # one tile: the TPU's rounding points, to fp32's order
        assert (out.float() - want_out.float()).abs().max() <= 2 ** -8


# ---------------------------------------------------------------------------
# the route through a block and a tower
# ---------------------------------------------------------------------------

def jax_tower(seed, layers):
    """A JAX transformer (stacked blocks, non-trivial LN and biases) and the
    port's Transformer holding the same weights."""
    rng = np.random.default_rng(seed)
    p = jax.device_get(JL.transformer_init(jax.random.PRNGKey(seed), D,
                                           layers))

    def noisy(leaf, centre):
        return (centre + 0.2 * rng.standard_normal(leaf.shape)
                ).astype(np.float32)

    for ln in ("ln_1", "ln_2"):
        p[ln]["scale"] = noisy(p[ln]["scale"], 1.0)
        p[ln]["bias"] = noisy(p[ln]["bias"], 0.0)
    p["attn"]["in_proj"]["b"] = noisy(p["attn"]["in_proj"]["b"], 0.0)
    p["attn"]["out_proj"]["b"] = noisy(p["attn"]["out_proj"]["b"], 0.0)
    sd = {}
    W._blocks_sd(p, layers, "resblocks", sd)
    tower = PL.Transformer(D, layers, H)
    tower.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in sd.items()})
    return p, tower


# the slice against JAX: both run their towers in bf16, but XLA's CPU
# products and torch's round at other places, and a one-ulp flip in one
# layer carries into the next; the bound is K1's own slice bound
# (tests/test_torch_ops.py: 6e-2)
SLICE_TOL = dict(atol=6e-2, rtol=6e-2)


@pytest.mark.parametrize("bias_kind", [None, "causal"])
def test_block_under_fused_attention_matches_jax_block_apply(bias_kind):
    p, tower = jax_tower(8, 1)
    N, L = 4, 12
    x = np.random.default_rng(8).standard_normal((N, L, D)).astype(np.float32)
    _, _, bias = case(8, N, L, bias_kind)
    jb = None if bias is None else jnp.asarray(bias)[:, None]
    want = JL.block_apply(jax.tree.map(lambda a: a[0], p), jbf16(x), H, jb,
                          dtype=jnp.bfloat16, fused_attention=True)
    got = tower.resblocks[0](
        bf16(x), None if bias is None else torch.as_tensor(bias),
        torch.bfloat16, fused_attention=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **SLICE_TOL)


@pytest.mark.parametrize("bias_kind", [None, "keypad"])
def test_tower_under_fused_attention_matches_jax_transformer_apply(bias_kind):
    """Two layers, forward and the gradient of a scalar with respect to the
    input, through the Pallas kernels' VJPs on the JAX side."""
    p, tower = jax_tower(9, 2)
    N, L = 3, 10
    rng = np.random.default_rng(9)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    cot = rng.standard_normal((N, L, D)).astype(np.float32)
    _, _, bias = case(9, N, L, bias_kind)
    jb = None if bias is None else jnp.asarray(bias)[:, None]

    def f(x):
        y = JL.transformer_apply(p, x, H, jb, dtype=jnp.bfloat16,
                                 fused_attention=True, unroll=True)
        return y.astype(jnp.float32)

    want, vjp = jax.vjp(f, jbf16(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    tx = bf16(x).requires_grad_(True)
    tb = None if bias is None else torch.as_tensor(bias)[:, None]
    got = tower(tx, tb, torch.bfloat16, fused_attention=True)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **SLICE_TOL)
    got.backward(bf16(cot))
    dx, want_dx = tx.grad.float().numpy(), np.asarray(
        want_dx.astype(jnp.float32))
    # a bf16 gradient through two layers: held as a whole
    assert np.linalg.norm(dx - want_dx) <= 3e-2 * np.linalg.norm(want_dx)


@pytest.mark.parametrize("bias_kind", [None, "causal"])
def test_three_routes_agree_in_fp32(bias_kind):
    """In fp32 nothing is rounded, so "block", the attention kernel's route
    and the einsum route are the same function with the same gradients."""
    _, tower = jax_tower(10, 2)
    N, L = 3, 9
    x = np.random.default_rng(10).standard_normal((N, L, D)).astype(np.float32)
    _, _, bias = case(10, N, L, bias_kind)
    tb = None if bias is None else torch.as_tensor(bias)[:, None]
    outs = []
    for route in ("block", True, False):
        tower.zero_grad()
        tx = torch.as_tensor(x).requires_grad_(True)
        y = tower(tx, tb, torch.float32, fused_attention=route)
        y.square().sum().backward()
        outs.append((y.detach(), tx.grad,
                     tower.resblocks[0].attn.in_proj_weight.grad.clone(),
                     tower.resblocks[1].ln_1.weight.grad.clone()))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["auto", "einsum", "fused", "fused_block"])
def test_resolve_fused_attention(impl, compute_dtype, device):
    """↔ neighborretr.resolve_fused_attention, with "one TPU chip" read as
    "a CUDA device" (no card is touched: only the device's type counts)."""
    cfg = dc.replace(ModelConfig.tiny(), attention_impl=impl,
                     compute_dtype=compute_dtype)
    if impl in ("fused", "fused_block") and compute_dtype == "float32":
        with pytest.raises(ValueError, match="attention_impl='einsum'"):
            resolve_fused_attention(cfg, device)
        return
    want = {"einsum": False, "fused": True, "fused_block": "block",
            "auto": ("block" if device == "cuda"
                     and compute_dtype == "bfloat16" else False)}[impl]
    assert resolve_fused_attention(cfg, torch.device(device)) == want


def test_resolve_fused_attention_refuses_unknown_names():
    with pytest.raises(ValueError, match="attention_impl"):
        resolve_fused_attention(
            dc.replace(ModelConfig.tiny(), attention_impl="flash"), "cpu")


@pytest.mark.parametrize("asked,L,on_cuda,want", [
    ("block", 64, True, "block"), ("block", 65, True, True),
    ("block", 577, True, True), ("block", 577, False, "block"),
    (True, 12, True, True), (True, 577, False, True),
    (False, 577, True, False), (False, 12, False, False)])
def test_block_route_demotes_one_level_past_64_tokens_on_cuda(asked, L,
                                                              on_cuda, want):
    """The sublayer kernel takes L <= 64; a longer sequence on the card goes
    to the attention kernel, not to the plain version.  On the CPU the plain
    sublayer serves any L."""
    assert PL.attention_route(asked, L, on_cuda) == want


def test_attention_route_refuses_unknown_values():
    with pytest.raises(ValueError, match="fused_attention"):
        PL.attention_route("fused", 12, False)
