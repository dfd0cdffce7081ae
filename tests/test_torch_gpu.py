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

pytestmark = pytest.mark.gpu

# kernel vs plain: K1 returns bf16 (two bf16 rounding steps); K2 is fp32
K1_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
K2_TOL = dict(atol=2e-5, rtol=1e-4)


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


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    args, _ = attn_inputs(0, 2, 12, 128, None, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        BA.ln_attention_residual(args[0].float(), *args[1:], 2)
    with pytest.raises(ValueError, match="head dim 64"):
        BA.ln_attention_residual(*args, 4)
    with pytest.raises(ValueError, match="w_qkv"):
        BA.ln_attention_residual(args[0], args[1], args[2],
                                 args[3].float(), *args[4:], 2)


def test_serving_path_runs_through_both_kernels(cuda):
    """Tiny towers in bf16 on the card: index + search through the kernels,
    held to the same path through the plain versions."""
    from neighborretr_tpu.core.config import Config, ModelConfig
    from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
    from neighborretr_tpu.data.loader import BatchLoader
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
