"""A CLIP checkpoint in OpenAI's exact layout, with seeded random weights:
the key names and shapes of the published `ViT-*.pt` files, in fp16, as a
TorchScript archive (as OpenAI publishes them) or a plain `torch.save`
dict.  It stands in for the published file where that is not at hand, so
the `--clip_checkpoint` path runs end to end on a machine with no network
(chip_smoke.py's phase 18, the CPU tests).

The weights are drawn with numpy from a seed (normal at CLIP's init
scales, LayerNorm scales around 1, logit_scale log(1/0.07)).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import ClipConfig


def _block_shapes(prefix: str, w: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.ln_1.weight": (w,), f"{prefix}.ln_1.bias": (w,),
            f"{prefix}.attn.in_proj_weight": (3 * w, w),
            f"{prefix}.attn.in_proj_bias": (3 * w,),
            f"{prefix}.attn.out_proj.weight": (w, w),
            f"{prefix}.attn.out_proj.bias": (w,),
            f"{prefix}.ln_2.weight": (w,), f"{prefix}.ln_2.bias": (w,),
            f"{prefix}.mlp.c_fc.weight": (4 * w, w),
            f"{prefix}.mlp.c_fc.bias": (4 * w,),
            f"{prefix}.mlp.c_proj.weight": (w, 4 * w),
            f"{prefix}.mlp.c_proj.bias": (w,)}


def openai_clip_shapes(c: ClipConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of an OpenAI ViT CLIP checkpoint of architecture
    `c`, by its name in the archive, with its shape."""
    vw, tw, P = c.vision_width, c.transformer_width, c.vision_patch_size
    shapes = {"visual.conv1.weight": (vw, 3, P, P),
              "visual.class_embedding": (vw,),
              "visual.positional_embedding": (c.grid_size ** 2 + 1, vw),
              "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,)}
    for i in range(c.vision_layers):
        shapes.update(_block_shapes(f"visual.transformer.resblocks.{i}", vw))
    shapes.update({"visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,),
                   "visual.proj": (vw, c.embed_dim),
                   "token_embedding.weight": (c.vocab_size, tw),
                   "positional_embedding": (c.context_length, tw)})
    for i in range(c.transformer_layers):
        shapes.update(_block_shapes(f"transformer.resblocks.{i}", tw))
    shapes.update({"ln_final.weight": (tw,), "ln_final.bias": (tw,),
                   "text_projection": (tw, c.embed_dim), "logit_scale": ()})
    return shapes


def random_openai_state_dict(c: ClipConfig,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random fp32 weights under `openai_clip_shapes(c)`'s names."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in openai_clip_shapes(c).items():
        if name == "logit_scale":
            sd[name] = np.array(math.log(1 / 0.07), np.float32)
        elif "ln_" in name and name.endswith(".weight"):
            sd[name] = (rng.random(shape, dtype=np.float32) + 0.5)
        elif name.endswith("bias"):
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02
        else:
            # x @ proj takes rows; a torch Linear or conv, its columns
            fan_in = (shape[0] if name.endswith("proj")
                      else int(np.prod(shape[1:])))
            std = (0.02 if name.endswith(("embedding", "embedding.weight"))
                   else fan_in ** -0.5)
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return sd


def save_openai_archive(sd: Dict[str, np.ndarray], c: ClipConfig, path: str,
                        torchscript: bool = True) -> None:
    """Write `sd` (fp32 numpy) in fp16: a TorchScript archive whose
    state_dict() holds these names and the non-parameter entries OpenAI's
    archives carry (weights_io.NON_PARAMETER_KEYS), or (torchscript=False)
    a plain torch.save dict."""
    tensors = {k: torch.tensor(np.asarray(v), dtype=torch.float16)
               for k, v in sd.items()}
    extras = {"input_resolution": c.image_resolution,
              "context_length": c.context_length, "vocab_size": c.vocab_size}
    if not torchscript:
        torch.save({**tensors, **{k: torch.tensor(v) for k, v
                                  in extras.items()}}, path)
        return
    root = torch.nn.Module()
    for name, t in tensors.items():
        module = root
        *parents, leaf = name.split(".")
        for p in parents:
            if p not in module._modules:
                module.add_module(p, torch.nn.Module())
            module = module._modules[p]
        module.register_parameter(leaf, torch.nn.Parameter(
            t, requires_grad=False))
    for k, v in extras.items():
        root.register_buffer(k, torch.tensor(v))
    torch.jit.script(root).save(path)
