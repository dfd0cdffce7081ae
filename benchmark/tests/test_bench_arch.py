"""The benchmark's description of a backbone other than OpenAI CLIP's 64-wide
heads: the reference block against `torch.nn`'s composition at a head width
of 80, the counts at an OpenCLIP-shaped backbone, and the rule by which the
hand-off to the program passes, holds or refuses a configuration's `clip`
keys."""

import copy
import dataclasses
from collections import OrderedDict

import pytest
import torch

from benchmark.counts import flops, kernels
from benchmark.harness import core, port
from benchmark.reference import model as R
from benchmark.reference.precision import Precision

MAN = core.manifest()

# OpenCLIP ViT-H/14's sizes (src/open_clip/model_configs/ViT-H-14.json:
# 16 heads of 80 in the vision tower, 16 of 64 in the text tower; the counts
# take no heads).
VIT_H14 = {"embed_dim": 1024, "image_resolution": 224, "vision_layers": 32,
           "vision_width": 1280, "vision_patch_size": 14,
           "transformer_width": 1024, "transformer_layers": 24}


class QuickGELU(torch.nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class Block(torch.nn.Module):
    """CLIP's ResidualAttentionBlock, with its state-dict names."""

    def __init__(self, width, heads):
        super().__init__()
        self.ln_1 = torch.nn.LayerNorm(width)
        self.attn = torch.nn.MultiheadAttention(width, heads,
                                                batch_first=True)
        self.ln_2 = torch.nn.LayerNorm(width)
        self.mlp = torch.nn.Sequential(OrderedDict([
            ("c_fc", torch.nn.Linear(width, 4 * width)),
            ("act", QuickGELU()),
            ("c_proj", torch.nn.Linear(4 * width, width))]))

    def forward(self, x, mask):
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, need_weights=False, attn_mask=mask)[0]
        return x + self.mlp(self.ln_2(x))


@pytest.mark.parametrize("causal", [False, True])
def test_block_at_head_width_80_is_torch_nn(causal):
    torch.manual_seed(21)
    N, L, D, H = 3, 9, 160, 2
    net = Block(D, H).double()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    x = torch.randn(N, L, D, dtype=torch.float64)
    i = torch.arange(L)
    bias = torch.where(i[None, :] > i[:, None], R.ATTN_NEG, 0.0).double() \
        if causal else None
    P = {"b." + k: v for k, v in net.state_dict().items()}
    got = R.block(P, "b.", x, H, None if bias is None else bias[None],
                  Precision())
    with torch.no_grad():
        want = net(x, bias)
    assert (got - want).abs().max().item() < 1e-10


@pytest.mark.parametrize("cell,want", [
    ("vitb32.msrvtt_train", 41_208_218_910_720),
    ("vitb16.msrvtt_train", 162_441_398_845_440),
])
def test_step_flops_of_the_train_cells_stay(cell, want):
    files = core.cell_files(MAN, cell)
    sizes = dict(port.reference_cfg(files)["model"], batch=128, bank=1920)
    assert flops.step_flops(sizes) == want


def test_step_flops_at_vit_h14_written_out():
    B, W, F, bank, E = 32, 24, 12, 480, 1024
    s = dict(VIT_H14, temporal_layers=4, max_words=W, max_frames=F,
             batch=B, bank=bank)
    NF, Lv, Dv, Dt = B * F, 257, 1280, 1024
    Mv, Mt = NF * Lv, B * W
    vis = 32 * (2 * Mv * Dv * 3 * Dv        # qkv
                + 2 * NF * Lv * Lv * Dv     # QK^T
                + 2 * NF * Lv * Lv * Dv     # PV
                + 2 * Mv * Dv * Dv          # out projection
                + 2 * Mv * Dv * 4 * Dv      # c_fc
                + 2 * Mv * 4 * Dv * Dv)     # c_proj
    stem = 2 * NF * 256 * (14 * 14 * 3) * Dv
    vis_proj = 2 * NF * Dv * E
    txt = 24 * (2 * Mt * Dt * 3 * Dt + 2 * B * W * W * Dt
                + 2 * B * W * W * Dt + 2 * Mt * Dt * Dt
                + 2 * Mt * Dt * 4 * Dt + 2 * Mt * 4 * Dt * Dt) \
        + 2 * Mt * Dt * E
    tmp = 4 * (2 * B * F * E * 3 * E + 2 * B * F * F * E + 2 * B * F * F * E
               + 2 * B * F * E * E + 2 * B * F * E * 4 * E
               + 2 * B * F * 4 * E * E)
    sims = 2 * 2 * B * B * W * F * E + 2 * 2 * B * bank * W * F * E
    ctm = 2 * 2 * B * W * W * E + 2 * 2 * B * F * F * E
    want = 3 * (vis + txt + tmp + sims + ctm) + stem + 3 * vis_proj
    assert flops.step_flops(s) == want


def test_attention_counts_at_vit_h14():
    N, L, D, H = 384, 257, 1280, 16
    f8, b8, _ = kernels.k8(N, L, D, H)
    f9, b9, _ = kernels.k9(N, L, D, H)
    assert f8 == 4 * N * L * L * D and f9 == 8 * N * L * L * D
    lse = N * H * L * kernels.F32
    assert b8 == 4 * N * L * D * kernels.BF16 + lse
    assert b9 == 8 * N * L * D * kernels.BF16 + lse


def test_program_config_takes_a_derived_key_that_agrees():
    files = copy.deepcopy(core.cell_files(MAN, "vitb32.msrvtt_train"))
    files["config"]["clip"].update(transformer_width=512,
                                   transformer_heads=8)
    cfg = port.program_config(files)
    assert cfg.model.clip.transformer_heads == 8


@dataclasses.dataclass(frozen=True)
class StandIn:
    """A program's `ClipConfig` in small: one field, one derived value."""
    width: int = 512

    @property
    def heads(self) -> int:
        return self.width // 64


@pytest.fixture
def stand_in(monkeypatch):
    from neighborretr_tpu_torch.core import config
    monkeypatch.setattr(config, "ClipConfig", StandIn)


def test_program_clip_passes_a_field(stand_in):
    assert port.program_clip({"width": 1280}) == StandIn(width=1280)


def test_program_clip_holds_a_derived_key_to_its_value(stand_in):
    assert port.program_clip({"width": 1280, "heads": 20}).width == 1280
    with pytest.raises(core.BenchError, match=r"'heads' = 16.*heads = 20"):
        port.program_clip({"width": 1280, "heads": 16})


@pytest.mark.parametrize("key,value", [("act", "gelu"),
                                       ("head_width", 80),
                                       ("__init__", 1)])
def test_program_clip_refuses_a_key_it_does_not_know(stand_in, key, value):
    with pytest.raises(core.BenchError, match=key):
        port.program_clip({key: value})
