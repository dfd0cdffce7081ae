"""neighborretr_tpu_torch — the PyTorch/CUDA port of neighborretr_tpu.

The JAX package beside it stays the reference.  This package imports
`torch` and never `jax`; it shares the JAX package's host modules that are
free of JAX (config dataclasses, tokenizer, caption encoding, batch loader,
datasets) instead of copying them.

Layout mirrors the JAX package module for module (`models/layers.py` ↔
`models/layers.py`, ...).  The TPU's Pallas kernels on the serving path are
hand-written CUDA C++ for Hopper under `csrc/`, built with `nvcc` at first
use (`ops/_build.py`); each sits beside a plain PyTorch version of the same
function, which is what a CPU tensor runs.
"""

__version__ = "0.1.0"
