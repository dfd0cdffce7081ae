"""Weights for the port: seeded init, the JAX package's parameter pytrees
and its `.npz` checkpoints (↔ neighborretr_tpu/models/weights_io.py and
core/checkpoint.py), all with numpy and torch only.

The JAX layouts map onto the reference's torch state-dict names the port's
modules carry: stacked layer axes unstack into `resblocks.{i}`, the
[D, 3, D] in_proj becomes torch's [3D, D] `in_proj_weight`, input-major
linears transpose, and the flattened [P·P·3, width] patch embedding
becomes the [width, 3, P, P] `conv1.weight`.  `to_jax_params` is the way
back: the port's state dict as the JAX package's pytree (numpy leaves), so
a test can compare every tensor after training steps in both packages.
`save_reference_checkpoint` writes the port's weights as the reference's
torch state dict (↔ weights_io.save_reference_checkpoint).

The readers take the published formats: an OpenAI CLIP archive (a
TorchScript `.pt` or a plain `torch.save` dict, fp16 or fp32) through
`load_openai_clip_into`, whose architecture is sniffed from the tensors'
shapes (the reference's modeling.py:88-101), and a reference-trained
`best.pth` through `load_reference_checkpoint_into`; `load_model_checkpoint`
dispatches a `--checkpoint` / `--init_checkpoint` by its file: `.npz` is
the JAX package's layout, anything else the reference's.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Dict

import numpy as np
import torch

from ..core.config import ClipConfig, ModelConfig

from .neighborretr import NeighborRetr, seed_temporal_from_clip

Tree = Dict[str, Any]
_SEP = "//"   # the JAX package's flat npz key separator
# entries of an OpenAI archive that are not parameters (OpenAI's own loader,
# clip.py::build_model, deletes them before load_state_dict)
NON_PARAMETER_KEYS = ("input_resolution", "context_length", "vocab_size")
WEIGHT_NETS = ("text_weight_fc", "video_weight_fc", "text_weight_fc1",
               "video_weight_fc1")


def _f32(a):
    return a.float() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _permute(a, *axes):
    return a.permute(*axes) if torch.is_tensor(a) else a.transpose(*axes)


def _block_sd(blocks: Tree, i: int, prefix: str, out: Dict[str, np.ndarray]):
    def leaf(*path):
        a = blocks
        for k in path:
            a = a[k]
        return _f32(a[i])

    in_w = leaf("attn", "in_proj", "w")
    d = in_w.shape[0]
    out[f"{prefix}.ln_1.weight"] = leaf("ln_1", "scale")
    out[f"{prefix}.ln_1.bias"] = leaf("ln_1", "bias")
    out[f"{prefix}.attn.in_proj_weight"] = in_w.reshape(d, 3 * d).T
    out[f"{prefix}.attn.in_proj_bias"] = leaf("attn", "in_proj", "b").reshape(-1)
    out[f"{prefix}.attn.out_proj.weight"] = leaf("attn", "out_proj", "w").T
    out[f"{prefix}.attn.out_proj.bias"] = leaf("attn", "out_proj", "b")
    out[f"{prefix}.ln_2.weight"] = leaf("ln_2", "scale")
    out[f"{prefix}.ln_2.bias"] = leaf("ln_2", "bias")
    for name in ("c_fc", "c_proj"):
        out[f"{prefix}.mlp.{name}.weight"] = leaf("mlp", name, "w").T
        out[f"{prefix}.mlp.{name}.bias"] = leaf("mlp", name, "b")


def _blocks_sd(blocks: Tree, n: int, prefix: str, out):
    for i in range(n):
        _block_sd(blocks, i, f"{prefix}.{i}", out)


def state_dict_from_jax_params(params: Tree,
                               cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The JAX package's parameter pytree → the port's state dict, under
    the reference's names.  Numpy leaves give numpy arrays; torch leaves
    give tensors made by torch ops (a traced program can take the JAX
    layout, deploy.py)."""
    f32 = _f32
    sd: Dict[str, np.ndarray] = {}
    c = cfg.clip
    vis, txt = params["clip"]["visual"], params["clip"]["text"]
    P, width = c.vision_patch_size, c.vision_width
    sd["clip.visual.conv1.weight"] = _permute(
        f32(vis["patch_embed"]).reshape(P, P, 3, width), 3, 2, 0, 1)
    sd["clip.visual.class_embedding"] = f32(vis["class_embedding"])
    sd["clip.visual.positional_embedding"] = f32(vis["positional_embedding"])
    sd["clip.visual.ln_pre.weight"] = f32(vis["ln_pre"]["scale"])
    sd["clip.visual.ln_pre.bias"] = f32(vis["ln_pre"]["bias"])
    _blocks_sd(vis["transformer"], c.vision_layers,
               "clip.visual.transformer.resblocks", sd)
    sd["clip.visual.ln_post.weight"] = f32(vis["ln_post"]["scale"])
    sd["clip.visual.ln_post.bias"] = f32(vis["ln_post"]["bias"])
    sd["clip.visual.proj"] = f32(vis["proj"])

    sd["clip.token_embedding.weight"] = f32(txt["token_embedding"])
    sd["clip.positional_embedding"] = f32(txt["positional_embedding"])
    _blocks_sd(txt["transformer"], c.transformer_layers,
               "clip.transformer.resblocks", sd)
    sd["clip.ln_final.weight"] = f32(txt["ln_final"]["scale"])
    sd["clip.ln_final.bias"] = f32(txt["ln_final"]["bias"])
    sd["clip.text_projection"] = f32(txt["text_projection"])
    sd["clip.logit_scale"] = f32(params["clip"]["logit_scale"]).reshape(())

    tmp = params["temporal"]
    sd["frame_position_embeddings.weight"] = f32(
        tmp["frame_position_embeddings"])
    _blocks_sd(tmp["transformer"], cfg.temporal_layers,
               "transformerClip.resblocks", sd)
    for name in WEIGHT_NETS:
        p = params[name]
        sd[f"{name}.0.weight"] = f32(p["fc1"]["w"]).T
        sd[f"{name}.0.bias"] = f32(p["fc1"]["b"])
        sd[f"{name}.2.weight"] = f32(p["fc2"]["w"]).T
        sd[f"{name}.2.bias"] = f32(p["fc2"]["b"])
    for modality in ("text", "video"):
        stack = params[f"{modality}_merge"]
        for i in (0, 1):
            c, b = stack[f"ctm{i}"], stack[f"block{i}"]
            cp, bp = f"{modality}_ctm{i}", f"{modality}_block{i}"
            # Conv1d [C_out, C_in, K] from the JAX [K, C_in, C_out]
            sd[f"{cp}.conv.conv.weight"] = _permute(f32(c["conv"]["w"]),
                                                    2, 1, 0)
            sd[f"{cp}.norm.weight"] = f32(c["norm"]["scale"])
            sd[f"{cp}.norm.bias"] = f32(c["norm"]["bias"])
            sd[f"{cp}.score.weight"] = f32(c["score"]["w"]).T
            sd[f"{cp}.score.bias"] = f32(c["score"]["b"])
            sd[f"{bp}.norm1.weight"] = f32(b["norm1"]["scale"])
            sd[f"{bp}.norm1.bias"] = f32(b["norm1"]["bias"])
            for lin in ("q", "kv", "proj"):
                sd[f"{bp}.attn.{lin}.weight"] = f32(b[lin]["w"]).T
                sd[f"{bp}.attn.{lin}.bias"] = f32(b[lin]["b"])
    return sd


def _blocks_tree(sd, prefix: str, n: int) -> Tree:
    """`prefix.{i}.*` blocks of a state dict → the JAX package's stacked
    transformer pytree (leading layer axis)."""
    def stack(key, fn=lambda a: a):
        return np.stack([fn(sd[f"{prefix}.{i}.{key}"]) for i in range(n)])

    d = sd[f"{prefix}.0.ln_1.weight"].shape[0]
    lin = {name: {"w": stack(f"mlp.{name}.weight", lambda a: a.T),
                  "b": stack(f"mlp.{name}.bias")} for name in ("c_fc", "c_proj")}
    return {
        "ln_1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "attn": {
            "in_proj": {
                "w": stack("attn.in_proj_weight",
                           lambda a: a.T.reshape(d, 3, d)),
                "b": stack("attn.in_proj_bias", lambda a: a.reshape(3, d))},
            "out_proj": {"w": stack("attn.out_proj.weight", lambda a: a.T),
                         "b": stack("attn.out_proj.bias")}},
        "ln_2": {"scale": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "mlp": lin,
    }


def to_jax_params(state_dict, cfg: ModelConfig) -> Tree:
    """The port's state dict (tensors or arrays) → the JAX package's
    parameter pytree with numpy fp32 leaves: the inverse of
    `state_dict_from_jax_params`."""
    sd = {k: np.asarray(v.detach().cpu().float() if torch.is_tensor(v) else v,
                        np.float32) for k, v in state_dict.items()}
    c = cfg.clip
    P, width = c.vision_patch_size, c.vision_width

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def lin(prefix):
        return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}

    params: Tree = {
        "clip": {
            "visual": {
                "patch_embed": sd["clip.visual.conv1.weight"].transpose(
                    2, 3, 1, 0).reshape(P * P * 3, width),
                "class_embedding": sd["clip.visual.class_embedding"],
                "positional_embedding": sd["clip.visual.positional_embedding"],
                "ln_pre": ln("clip.visual.ln_pre"),
                "transformer": _blocks_tree(
                    sd, "clip.visual.transformer.resblocks", c.vision_layers),
                "ln_post": ln("clip.visual.ln_post"),
                "proj": sd["clip.visual.proj"],
            },
            "text": {
                "token_embedding": sd["clip.token_embedding.weight"],
                "positional_embedding": sd["clip.positional_embedding"],
                "transformer": _blocks_tree(sd, "clip.transformer.resblocks",
                                            c.transformer_layers),
                "ln_final": ln("clip.ln_final"),
                "text_projection": sd["clip.text_projection"],
            },
            "logit_scale": sd["clip.logit_scale"].reshape(()),
        },
        "temporal": {
            "frame_position_embeddings": sd["frame_position_embeddings.weight"],
            "transformer": _blocks_tree(sd, "transformerClip.resblocks",
                                        cfg.temporal_layers),
        },
    }
    for name in WEIGHT_NETS:
        params[name] = {"fc1": lin(f"{name}.0"), "fc2": lin(f"{name}.2")}
    for modality in ("text", "video"):
        stack = {}
        for i in (0, 1):
            cp, bp = f"{modality}_ctm{i}", f"{modality}_block{i}"
            stack[f"ctm{i}"] = {
                "conv": {"w": sd[f"{cp}.conv.conv.weight"].transpose(2, 1, 0)},
                "norm": ln(f"{cp}.norm"), "score": lin(f"{cp}.score")}
            stack[f"block{i}"] = {
                "norm1": ln(f"{bp}.norm1"),
                **{name: lin(f"{bp}.attn.{name}")
                   for name in ("q", "kv", "proj")}}
        params[f"{modality}_merge"] = stack
    return params


def from_jax_params(params: Tree, cfg: ModelConfig,
                    device=None) -> NeighborRetr:
    """A port model holding the JAX package's weights (numpy pytree, e.g.
    `jax.device_get(init_params(...))`)."""
    model = NeighborRetr(cfg, device=device)
    sd = state_dict_from_jax_params(params, cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model.eval().requires_grad_(False)


def reference_state_dict(model: NeighborRetr) -> Dict[str, torch.Tensor]:
    """The port's weights as the reference's torch state dict
    (modeling.py:46 names; ↔ weights_io.reference_state_dict_from_params):
    fp32, contiguous, on the CPU.  The port's module names are the
    reference's, and it holds nothing the JAX exporter leaves out (the
    reference's unused weighting nets *_fc0 / *_intra and its mb_*
    buffers), so this is its state dict.  A scalar (logit_scale) is
    written with shape [1], as the JAX exporter writes it (np.
    ascontiguousarray of a 0-d array); load_state_dict reads a [1] tensor
    into a 0-d parameter."""
    return {k: v.detach().to("cpu", torch.float32).reshape(
                v.shape or (1,)).contiguous()
            for k, v in model.state_dict().items()}


def save_reference_checkpoint(model: NeighborRetr, path: str) -> None:
    """torch.save a reference-layout checkpoint (loadable by the reference's
    --init_model / load_state_dict(strict=False))."""
    torch.save(reference_state_dict(model), path)


def read_npz_params(path: str) -> Tree:
    """The JAX package's `.npz` checkpoint → nested numpy pytree.  Takes the
    params-only layout (`clip//text//...`, best.npz) and the full
    train-state layout (`params//clip//...` beside `opt_step`)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    prefix = f"params{_SEP}"
    if "opt_step" in flat and any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    tree: Tree = {}
    for key, value in flat.items():
        node = tree
        *parents, last = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    return tree


def load_checkpoint(path: str, cfg: ModelConfig, device=None) -> NeighborRetr:
    return from_jax_params(read_npz_params(path), cfg, device=device)


@torch.no_grad()
def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> NeighborRetr:
    """Seeded random weights with the JAX package's init distributions
    (init_params): CLIP scales for the towers, normal(0.02) weight nets,
    torch defaults for the CTM conv and score head, truncated normal(0.02)
    TC-block linears, logit_scale 1.0, the temporal tower seeded from the
    text tower.  The numbers differ from JAX's for the same seed (another
    generator).

    Each tensor draws from its own generator, seeded from `seed` and the
    tensor's name — like the JAX package's per-subtree key splits, one
    tensor's shape (e.g. the vocabulary size) changes no other tensor."""
    model = NeighborRetr(cfg, device=device)
    names = {id(p): n for n, p in model.named_parameters()}

    def gen(t):
        return torch.Generator(device=t.device).manual_seed(
            seed * 1_000_003 + zlib.crc32(names[id(t)].encode()))

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen(t), device=t.device) * std)

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=gen(t))

    def trunc_normal_(t, std):
        torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                    generator=gen(t))

    def init_transformer(tf, width, layers):
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        for blk in tf.resblocks:
            for ln in (blk.ln_1, blk.ln_2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
            normal_(blk.attn.in_proj_weight, width ** -0.5)
            blk.attn.in_proj_bias.zero_()
            normal_(blk.attn.out_proj.weight, proj_std)
            blk.attn.out_proj.bias.zero_()
            normal_(blk.mlp.c_fc.weight, (2 * width) ** -0.5)
            blk.mlp.c_fc.bias.zero_()
            normal_(blk.mlp.c_proj.weight, proj_std)
            blk.mlp.c_proj.bias.zero_()

    c, clip = cfg.clip, model.clip
    vis = clip.visual
    scale = c.vision_width ** -0.5
    normal_(vis.conv1.weight, scale)
    normal_(vis.class_embedding, scale)
    normal_(vis.positional_embedding, scale)
    normal_(vis.proj, scale)
    init_transformer(vis.transformer, c.vision_width, c.vision_layers)
    normal_(clip.token_embedding.weight, 0.02)
    normal_(clip.positional_embedding, 0.01)
    init_transformer(clip.transformer, c.transformer_width,
                     c.transformer_layers)
    normal_(clip.text_projection, c.transformer_width ** -0.5)
    for ln in (vis.ln_pre, vis.ln_post, clip.ln_final):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    clip.logit_scale.fill_(1.0)
    for name in WEIGHT_NETS:
        mlp = getattr(model, name)
        for lin in (mlp[0], mlp[2]):
            normal_(lin.weight, 0.02)
            lin.bias.zero_()
    width = cfg.width
    for modality in ("text", "video"):
        for i in (0, 1):
            c_, b_ = (getattr(model, f"{modality}_{kind}{i}")
                      for kind in ("ctm", "block"))
            uniform_(c_.conv.conv.weight, (width * 3) ** -0.5)
            uniform_(c_.score.weight, width ** -0.5)
            uniform_(c_.score.bias, width ** -0.5)
            for lnm in (c_.norm, b_.norm1):
                lnm.weight.fill_(1.0)
                lnm.bias.zero_()
            for lin in (b_.attn.q, b_.attn.kv, b_.attn.proj):
                trunc_normal_(lin.weight, 0.02)
                lin.bias.zero_()
    seed_temporal_from_clip(model)
    return model.eval().requires_grad_(False)


def read_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's tensors as fp32 on the CPU: a TorchScript
    archive (OpenAI's published `.pt`) or a `torch.save` dict (a reference
    `best.pth`, the JAX exporter's file).  OpenAI's archives hold fp16; the
    entries that are not parameters are dropped."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file {path!r}")
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().to("cpu", torch.float32) for k, v in sd.items()
            if k not in NON_PARAMETER_KEYS}


def sniff_clip_config(sd) -> ClipConfig:
    """Architecture dims from a CLIP state dict's shapes (modeling.py:88-101;
    ↔ weights_io.sniff_clip_config)."""
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid_size,
        vision_layers=len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


def _load_exactly(module: torch.nn.Module, sd) -> None:
    """Copy `sd` into every tensor of `module`'s state dict; a key of the
    module missing from `sd` raises, keys of `sd` the module lacks are
    ignored.  A tensor of the same size in another shape (logit_scale, 0-d
    here and [1] in an exported file) is reshaped."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensor(s) of the "
                       f"model: {', '.join(missing[:8])}"
                       + (" ..." if len(missing) > 8 else ""))
    module.load_state_dict({k: sd[k].reshape(v.shape) for k, v in own.items()},
                           strict=True)


def load_openai_clip_into(model: NeighborRetr, path: str) -> NeighborRetr:
    """An OpenAI CLIP checkpoint into `model.clip`, in place, then the
    temporal tower and frame positions re-seeded from the loaded text tower
    (↔ weights_io.load_openai_clip_into)."""
    sd = read_torch_state_dict(path)
    sniffed = sniff_clip_config(sd)
    if sniffed != model.cfg.clip:
        raise ValueError(f"checkpoint architecture {sniffed} != configured "
                         f"{model.cfg.clip}")
    _load_exactly(model.clip, sd)
    return seed_temporal_from_clip(model)


def load_reference_checkpoint_into(model: NeighborRetr,
                                   path: str) -> NeighborRetr:
    """A reference-trained full-model checkpoint (`best.pth` /
    `pytorch_model.bin.*`, main.py:161-187) into `model`, in place
    (↔ weights_io.load_reference_checkpoint_into): CLIP, the temporal
    tower, the four weighting nets and the merge stacks.  The reference's
    dead weighting nets (*_fc0 / *_intra) and its mb_* buffers are
    ignored."""
    sd = read_torch_state_dict(path)
    clip_sd = {k[len("clip."):]: v for k, v in sd.items()
               if k.startswith("clip.")}
    if not clip_sd:
        raise ValueError(
            f"{path!r} is not a reference NeighborRetr checkpoint (no "
            f"'clip.'-prefixed keys).  A bare OpenAI CLIP backbone (.pt) "
            f"goes through --clip_checkpoint, not the model-checkpoint flag.")
    sniffed = sniff_clip_config(clip_sd)
    if sniffed != model.cfg.clip:
        raise ValueError(
            f"reference checkpoint {path!r} is a different architecture "
            f"than --base_encoder: checkpoint {sniffed} != configured "
            f"{model.cfg.clip}")
    _load_exactly(model, sd)
    return model


def load_model_checkpoint(model: NeighborRetr, path: str, strict: bool = True,
                          logger=None) -> NeighborRetr:
    """One dispatch for model checkpoints across the CLIs, in place
    (↔ weights_io.load_model_checkpoint_into): an `.npz` of either package
    (best.npz, or a train-state file whose params are taken), else a
    reference-trained torch checkpoint.  strict=False is the warm start
    (the reference's --init_model): an npz loads what matches and the diff
    is logged."""
    if not path.endswith(".npz"):
        return load_reference_checkpoint_into(model, path)
    from ..core import checkpoint as ckpt
    if strict:
        ckpt.load_tree_into_model(model, read_npz_params(path))
        return model
    tree, report = ckpt.load_params(path, ckpt.params_tree(model),
                                    strict=False)
    ckpt.load_tree_into_model(model, tree)
    if logger is not None:
        for kind, names in report.items():
            if names:
                logger.info("  warm-start %s leaves (%d): %s", kind,
                            len(names), ", ".join(names[:8])
                            + (" ..." if len(names) > 8 else ""))
    return model
