"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `gpu` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports no JAX, so it also runs where
JAX is not installed; the repository's conftest.py imports JAX, hence:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from neighborretr_tpu_torch.ops import block_attention as BA
from neighborretr_tpu_torch.ops import similarity as S
from neighborretr_tpu_torch.ops import similarity_blocked as SB

pytestmark = pytest.mark.gpu

# kernel vs plain: K1 returns bf16 (two bf16 rounding steps); K2 is fp32
K1_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
K2_TOL = dict(atol=2e-5, rtol=1e-4)
# K3's fp32 sums over all rows (weight and bias gradients): bf16 operands
# that flip by one ulp where differently ordered fp32 sums straddle a
# rounding boundary move single terms by 2^-8 of their size, so the bound
# is relative to the tensor's largest entry, not elementwise
K3_SUM_TOL = 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def sim_inputs(seed, A, B, T, V, D, device):
    rng = np.random.default_rng(seed)
    tm = (rng.uniform(size=(A, T)) > 0.25).astype(np.float32)
    vm = (rng.uniform(size=(B, V)) > 0.25).astype(np.float32)
    tm[:, 0] = 1
    vm[:, 0] = 1
    arrays = (rng.normal(size=(A, T, D)), rng.normal(size=(B, V, D)), tm, vm,
              rng.dirichlet(np.ones(T), size=A), rng.dirichlet(np.ones(V),
                                                               size=B))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


@pytest.mark.parametrize("A,B,T,V,D", [(5, 37, 7, 3, 64),
                                       (64, 1000, 24, 12, 512),
                                       (3, 129, 64, 16, 128)])
def test_similarity_kernel_matches_plain(cuda, A, B, T, V, D):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = S.fused_interaction_similarity.launches
    got = S.fused_interaction_similarity(*args)
    torch.cuda.synchronize()
    assert S.fused_interaction_similarity.launches == before + 1
    torch.testing.assert_close(got, S.interaction_similarity(*args), **K2_TOL)


SIM_SHAPES = [(5, 37, 7, 3, 64), (64, 200, 24, 12, 512), (200, 64, 24, 12, 512),
              (3, 129, 64, 16, 128)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("A,B,T,V,D", SIM_SHAPES)
def test_mean_kernel_matches_plain(cuda, A, B, T, V, D, axis):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = S.fused_interaction_mean.launches
    got = S.fused_interaction_mean(*args, axis=axis)
    torch.cuda.synchronize()
    assert S.fused_interaction_mean.launches == before + 1
    assert got.shape == ((A,) if axis == 1 else (B,))
    torch.testing.assert_close(got, S.interaction_mean(*args, axis=axis),
                               **K2_TOL)
    assert torch.equal(got, S.fused_interaction_mean(*args, axis=axis))


def test_mean_kernel_refuses_bfloat16(cuda):
    args = sim_inputs(0, 4, 8, 6, 3, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        S.fused_interaction_mean(*args, axis=1, sim_dtype="bfloat16")


@pytest.mark.parametrize("A,B,T,V,D", SIM_SHAPES)
def test_similarity_backward_kernel_matches_plain(cuda, A, B, T, V, D):
    """Masked tokens make whole rows of logits tie at 0; duplicated video
    tokens make ties among live logits too."""
    tf, vf, tm, vm, tw, vw = sim_inputs(A * B, A, B, T, V, D, cuda)
    vf[:, V - 1] = vf[:, 0]
    vm[:, V - 1] = vm[:, 0]
    tn, vn, tw, vw = S._prepare(tf, vf, tm, vm, tw, vw, True)
    g = torch.as_tensor(np.random.default_rng(7).standard_normal((A, B)),
                        dtype=torch.float32, device=cuda)
    before = S.fused_similarity_bwd.launches
    got = S.fused_similarity_bwd(tn, vn, tw, vw, g)
    torch.cuda.synchronize()
    assert S.fused_similarity_bwd.launches == before + 1
    want = S.similarity_bwd_plain(tn, vn, tw, vw, g)
    for name, a, b in zip(("dtn", "dvn", "dtw", "dvw"), got, want):
        torch.testing.assert_close(a, b, atol=2e-5 * max(A, B) ** 0.5,
                                   rtol=1e-4, msg=lambda m: f"{name}: {m}")
    again = S.fused_similarity_bwd(tn, vn, tw, vw, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_similarity_autograd_kernels_match_plain(cuda, axis):
    args = sim_inputs(3, 9, 40, 7, 3, 64, cuda)

    def grads(kernels):
        leaves = [a.clone().requires_grad_(i in (0, 1, 4, 5))
                  for i, a in enumerate(args)]
        if axis is None:
            out = S.fused_interaction_similarity(*leaves, kernels=kernels)
        else:
            out = S.fused_interaction_mean(*leaves, axis=axis,
                                           kernels=kernels)
        out.square().sum().backward()
        return [leaves[i].grad for i in (0, 1, 4, 5)]

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


# the blocked kernels at small shapes (odd token counts, tiles with several
# captions and videos, ragged edges) and at the long-token train step's
# three: in-batch, text x bank videos, bank texts x videos
BLOCKED_SHAPES = [(5, 37, 7, 3, 64), (3, 9, 64, 64, 32), (9, 5, 33, 17, 48),
                  (130, 70, 64, 16, 128), (128, 128, 64, 64, 512),
                  (128, 1920, 64, 64, 512), (1920, 128, 64, 64, 512)]


def exact_inputs(seed, A, B, T, V, D, device):
    """Prepared inputs whose logits are exact in fp32 in any summation
    order (entries are multiples of 1/8 up to 1/2, D <= 512), so the kernel
    and the plain version see the same maxima and the same ties, of which
    there are many; masked tokens are zero rows."""
    rng = np.random.default_rng(seed)
    tm = np.arange(T)[None] < rng.integers(1, T + 1, A)[:, None]
    vm = np.arange(V)[None] < rng.integers(1, V + 1, B)[:, None]
    tn = rng.integers(-4, 5, (A, T, D)) / 8.0 * tm[..., None]
    vn = rng.integers(-4, 5, (B, V, D)) / 8.0 * vm[..., None]
    vn[:, V - 1] = vn[:, 0]                     # duplicated video tokens
    arrays = (tn, vn, rng.dirichlet(np.ones(T), size=A),
              rng.dirichlet(np.ones(V), size=B), rng.standard_normal((A, B)))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


@pytest.mark.parametrize("A,B,T,V,D", BLOCKED_SHAPES)
def test_blocked_similarity_kernel_matches_plain(cuda, A, B, T, V, D):
    args = sim_inputs(A + B, A, B, T, V, D, cuda)
    before = SB.fused_interaction_similarity_blocked.launches
    got = SB.fused_interaction_similarity_blocked(*args)
    torch.cuda.synchronize()
    assert SB.fused_interaction_similarity_blocked.launches == before + 1
    want = SB.fused_interaction_similarity_blocked(*args, kernels=False)
    torch.testing.assert_close(got, want, **K2_TOL)


@pytest.mark.parametrize("A,B,T,V,D", BLOCKED_SHAPES)
def test_blocked_backward_kernel_matches_plain(cuda, A, B, T, V, D):
    """On inputs with exact logits every gradient agrees elementwise, ties
    included, and two runs give the same bits."""
    tn, vn, tw, vw, g = exact_inputs(A * B, A, B, T, V, D, cuda)
    out, m1, i1 = SB._blocked_fwd(tn, vn, tw, vw, save=True)
    torch.testing.assert_close(out, SB.similarity_blocked_plain(tn, vn, tw, vw),
                               **K2_TOL)
    before = SB.fused_blocked_similarity_bwd.launches
    got = SB.fused_blocked_similarity_bwd(tn, vn, tw, vw, g, m1, i1)
    torch.cuda.synchronize()
    assert SB.fused_blocked_similarity_bwd.launches == before + 1
    want = SB.similarity_blocked_bwd_plain(tn, vn, tw, vw, g)
    for name, a, b in zip(("dtn", "dvn", "dtw", "dvw"), got, want):
        torch.testing.assert_close(a, b, atol=2e-5 * max(A, B) ** 0.5,
                                   rtol=1e-4, msg=lambda m: f"{name}: {m}")
    again = SB.fused_blocked_similarity_bwd(tn, vn, tw, vw, g, m1, i1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_blocked_autograd_kernels_match_plain(cuda):
    """Through the wrapper (masks, normalisation, residuals) at a small
    long-token shape; real-valued logits, where a near-tie may route
    otherwise in the two versions, so the features' gradients are held as a
    whole."""
    args = sim_inputs(5, 6, 20, 64, 32, 64, cuda)

    def grads(kernels):
        leaves = [a.clone().requires_grad_(i in (0, 1, 4, 5))
                  for i, a in enumerate(args)]
        out = SB.fused_interaction_similarity_blocked(*leaves, kernels=kernels)
        out.square().sum().backward()
        return [leaves[i].grad for i in (0, 1, 4, 5)]

    k, p = grads(True), grads(False)
    for a, b in zip(k[2:], p[2:]):              # the weights' gradients
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)
    for a, b in zip(k[:2], p[:2]):
        assert ((a - b).norm() / b.norm()).item() <= 1e-3


def test_blocked_kernel_refuses_what_it_does_not_take(cuda):
    args = sim_inputs(0, 2, 3, 65, 32, 64, cuda)
    with pytest.raises(ValueError, match="T, V <= 64"):
        SB.fused_interaction_similarity_blocked(*args)
    args = sim_inputs(0, 2, 3, 64, 32, 24, cuda)
    with pytest.raises(ValueError, match="D % 16"):
        SB.fused_interaction_similarity_blocked(*args)


def attn_inputs(seed, N, L, D, bias_kind, device):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    args = (t(rng.standard_normal((N, L, D)), torch.bfloat16),
            t(1 + 0.1 * rng.standard_normal(D)), t(0.1 * rng.standard_normal(D)),
            t(rng.standard_normal((3 * D, D)) * D ** -0.5, torch.bfloat16),
            t(0.1 * rng.standard_normal(3 * D)),
            t(rng.standard_normal((D, D)) * D ** -0.5, torch.bfloat16),
            t(0.1 * rng.standard_normal(D)))
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, L + 1, size=N)
        j = np.arange(L)
        fill = -1e9 if bias_kind == "causal" else -1e6
        pad = np.where(j[None] < lens[:, None], 0.0, fill)[:, None, :]
        b = np.broadcast_to(pad, (N, L, L))
        if bias_kind == "causal":
            b = b + np.where(j[None, :] > j[:, None], -1e9, 0.0)[None]
        bias = t(np.ascontiguousarray(b))
    return args, bias


@pytest.mark.parametrize("N,L,D,H,bias_kind", [
    (6, 50, 768, 12, None),          # vision
    (64, 24, 512, 8, "causal"),      # text
    (64, 12, 512, 8, "keypad"),      # temporal
    (3, 5, 64, 1, None),             # tiny tower, one m-tile
    (2, 64, 128, 2, "causal")])      # longest sequence the kernel takes
def test_attention_kernel_matches_plain(cuda, N, L, D, H, bias_kind):
    args, bias = attn_inputs(N * L, N, L, D, bias_kind, cuda)
    before = BA.ln_attention_residual.launches
    got = BA.ln_attention_residual(*args, H, bias)
    torch.cuda.synchronize()
    assert BA.ln_attention_residual.launches == before + 1
    want = BA.ln_attention_residual_plain(*args, H, bias)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL)


@pytest.mark.parametrize("N,L,D,H,bias_kind", [
    (6, 50, 768, 12, None),          # vision
    (64, 24, 512, 8, "causal"),      # text
    (64, 12, 512, 8, "keypad"),      # temporal
    (3, 5, 64, 1, None),             # N·L not a multiple of 64, one m-tile
    (2, 64, 128, 2, "causal")])
def test_attention_backward_kernel_matches_plain(cuda, N, L, D, H, bias_kind):
    args, bias = attn_inputs(N * L, N, L, D, bias_kind, cuda)
    rng = np.random.default_rng(N + L)
    g = torch.as_tensor(rng.standard_normal((N, L, D)).astype(np.float32),
                        device=cuda).bfloat16()
    before = BA.ln_attention_residual_bwd.launches
    got = BA.ln_attention_residual_bwd(*args, H, g, bias)
    torch.cuda.synchronize()
    assert BA.ln_attention_residual_bwd.launches == before + 1
    want = BA.ln_attention_residual_bwd_plain(*args, H, g, bias)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), **K1_TOL)
    names = ("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out", "db_out")
    for name, a, b in zip(names, got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= K3_SUM_TOL * b.abs().max().item(), (name, err)
    again = BA.ln_attention_residual_bwd(*args, H, g, bias)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_attention_sublayer_autograd_runs_both_kernels(cuda):
    args, bias = attn_inputs(1, 4, 12, 128, "keypad", cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    f, b = BA.ln_attention_residual.launches, \
        BA.ln_attention_residual_bwd.launches
    y = BA.ln_attention_sublayer(*leaves, 2, bias)
    y.float().square().sum().backward()
    assert BA.ln_attention_residual.launches == f + 1
    assert BA.ln_attention_residual_bwd.launches == b + 1
    plain = [a.clone().requires_grad_(True) for a in args]
    BA.ln_attention_sublayer(*plain, 2, bias, kernels=False
                             ).float().square().sum().backward()
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == got.dtype
        err = (got.grad.float() - want.grad.float()).abs().max().item()
        assert err <= 2 ** -5 * want.grad.float().abs().max().item()


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    args, _ = attn_inputs(0, 2, 12, 128, None, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        BA.ln_attention_residual(args[0].float(), *args[1:], 2)
    with pytest.raises(ValueError, match="head dim 64"):
        BA.ln_attention_residual(*args, 4)
    with pytest.raises(ValueError, match="w_qkv"):
        BA.ln_attention_residual(args[0], args[1], args[2],
                                 args[3].float(), *args[4:], 2)
    g = torch.zeros_like(args[0])
    with pytest.raises(ValueError, match="bfloat16"):   # fp32 activations
        BA.ln_attention_residual_bwd(args[0].float(), *args[1:], 2, g)
    with pytest.raises(ValueError, match="g must be"):
        BA.ln_attention_residual_bwd(*args, 2, g.float())


def test_serving_path_runs_through_both_kernels(cuda):
    """Tiny towers in bf16 on the card: index + search through the kernels,
    held to the same path through the plain versions."""
    from neighborretr_tpu_torch.core.config import Config, ModelConfig
    from neighborretr_tpu_torch.data.datasets.synthetic import SyntheticDataset
    from neighborretr_tpu_torch.data.loader import BatchLoader
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.models.weights_io import init_model

    m = dc.replace(ModelConfig.tiny(max_words=8, max_frames=4),
                   compute_dtype="bfloat16")
    cfg = Config(model=m)
    model = init_model(m, seed=0, device=cuda)
    ds = SyntheticDataset(n=20, seed=3, max_words=8, max_frames=4,
                          resolution=m.clip.image_resolution,
                          vocab_size=m.clip.vocab_size)

    class Tok:   # whitespace ids onto the tiny vocab
        def tokenize(self, text):
            return text.split()

        def convert_tokens_to_ids(self, tokens):
            return [1 + sum(map(ord, t)) % 500 for t in tokens]

    def index(kernels):
        loader = BatchLoader(ds, 8, shuffle=False, drop_last=False,
                             workers=0, pad_to_batch=True)
        return serving.build_video_index(model, cfg, loader, dataset=ds,
                                         kernels=kernels)

    k1, k2 = BA.ln_attention_residual.launches, \
        S.fused_interaction_similarity.launches
    idx = index(True)
    queries = ["a dog runs", "cooking pasta", "x"]
    got = serving.Searcher(model, cfg, idx, Tok()).similarities(queries)
    torch.cuda.synchronize()
    # 3 index batches x (2 vision + 2 temporal blocks) + 2 text blocks
    assert BA.ln_attention_residual.launches - k1 == 3 * 4 + 2
    assert S.fused_interaction_similarity.launches - k2 == 1
    want = serving.Searcher(model, cfg, index(False), Tok(),
                            kernels=False).similarities(queries)
    assert got.shape == (3, 20) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_train_step_runs_through_the_training_kernels(cuda):
    """Tiny towers in bf16 on the card: one bank fill and two optimizer
    steps; launches counted per step, losses held to the plain run."""
    from neighborretr_tpu_torch.core import config as C
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    m = dc.replace(C.ModelConfig.tiny(max_words=8, max_frames=4),
                   compute_dtype="bfloat16")
    B = 8
    cfg = C.Config(model=m, loss=C.LossConfig(num_neighbors=3),
                   data=C.DataConfig(max_words=8, max_frames=4),
                   train=C.TrainConfig(batch_size=B, mb_batch=2))
    model = init_model(m, seed=0, device=cuda)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [TS.to_device(make_synthetic_batch(m, B, seed=s), cuda)
               for s in range(4)]
    fns = (BA.ln_attention_residual, BA.ln_attention_residual_bwd,
           S.fused_interaction_mean, S.fused_similarity_bwd,
           S.fused_interaction_similarity)
    layers = 2 + 2 + 2                 # vision, text, temporal blocks

    def run(kernels):
        model.load_state_dict(start)
        bank = MB.create(2 * B, 8, 4, m.width, device=cuda)
        for i in range(2):
            bank = TS.fill_bank_step(model, bank, batches[i], cfg, i * B,
                                     kernels)
        state = TS.create_train_state(model, bank)
        gen = torch.Generator(device=cuda).manual_seed(0)
        losses = []
        for batch in batches[2:]:
            before = [f.launches for f in fns]
            state, met = TS.train_step(state, batch, cfg, 10, gen, kernels)
            torch.cuda.synchronize()
            if kernels:
                assert [f.launches - b for f, b in zip(fns, before)] == \
                    [layers, layers, 2, 2, 0]
            losses.append(met["loss"].item())
        return losses, state

    got, state = run(True)
    assert np.isfinite(got).all()
    assert torch.equal(state.bank.ind[:B], batches[3]["idx"].to(torch.int32))
    assert not torch.equal(model.clip.text_projection,
                           start["clip.text_projection"])
    assert torch.equal(model.clip.visual.conv1.weight,
                       start["clip.visual.conv1.weight"])
    want, _ = run(False)
    np.testing.assert_allclose(got, want, rtol=2e-2)
