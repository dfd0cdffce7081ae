"""Weights made by the benchmark from the seed, handed alike to the program
and to the reference.

One generator on the run's device draws every random leaf in one call, in
float32 (the type the program keeps its parameters in); each leaf is a
slice of that draw times its own scale.  The scales follow CLIP's init:
LayerNorm scales 1, biases 0, the token embedding 0.02, positional
embeddings 0.01, the logit scale log(1/0.07), every other tensor
fan_in^-1/2 (the projections [width, embed] by their first axis).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

ONES = ("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight",
        "ln_final.weight", "norm.weight", "norm1.weight")
IN_OUT = ("clip.visual.proj", "clip.text_projection")


def scale_of(name: str, shape: Sequence[int]):
    """The leaf's constant (a float) or its standard deviation (a tuple)."""
    if name == "clip.logit_scale":
        return math.log(1 / 0.07)
    if name.endswith(ONES):
        return 1.0
    if name.endswith("bias"):
        return 0.0
    if name == "clip.token_embedding.weight":
        return (0.02,)
    if name.endswith("positional_embedding") or \
            name == "frame_position_embeddings.weight":
        return (0.01,)
    if name in IN_OUT:
        return (shape[0] ** -0.5,)
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    return (fan_in ** -0.5,)


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """name → float32 tensor on `device` for each (name, shape)."""
    total = sum(math.prod(s) for n, s in shapes
                if isinstance(scale_of(n, s), tuple))
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        sc = scale_of(name, shape)
        if isinstance(sc, tuple):
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape).mul_(sc[0])
            at += n
        else:
            out[name] = torch.full(shape, sc, device=device)
    return out
