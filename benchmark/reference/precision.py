"""How the reference rounds the operands of its matrix products.

The reference computes in float32 with TF32 off.  Its control computes the
towers one precision below what the configuration states (bfloat16 there):
every operand of a tower's product is rounded to float8 e4m3 with one scale
per tensor (its absolute maximum onto e4m3's largest finite value, 448), as
an fp8 deployment would.  Under autograd the rounding passes the gradient
straight through.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
KINDS = ("float32", "float8")


def set_float32_exact() -> None:
    """Products in full float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The rounding of the towers' product operands: "float32" (none) or
    "float8" (the control)."""

    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
        self.kind = kind

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(spec, self.r(a), self.r(b))

    def linear(self, x, w, b=None):
        y = self.r(x) @ self.r(w).T
        return y if b is None else y + b
