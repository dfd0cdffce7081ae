"""Deployment bundles: the serving query program as a portable artifact
(↔ neighborretr_tpu/deploy.py).

`torch.export` traces the whole query computation (text encoding through
the CLIP text tower, the token-interaction similarity against the corpus,
the top-k) into one program; a serving host loads it with
`torch.export.load` and runs it with torch and numpy alone: no code of this
package, no tracing at load time.

A bundle runs no hand kernel.  The kernels are ctypes calls into libraries
nvcc builds at first use (ops/_build.py): they are not torch operators, so
`torch.export` cannot record them, and a bundle is meant to run where
neither this package nor nvcc is.  The program therefore pins the plain
versions (`kernels=False`: each kernel's plain PyTorch version on the
attention route `cfg.attention_impl` picks for the device), as the JAX
exporter pins its XLA paths because Pallas custom calls cannot be
serialised; it computes what `serving.Searcher(kernels=False)` computes.
It runs on the device it was exported for (`meta["platforms"]`): the
traced constants (the causal bias, the masks' fills) live there.

Bundle layout (a directory), the JAX bundle's with the program's format:
  query_program.pt2   the torch.export program
  params.npz          the parameters in the JAX package's npz key layout
                      (`clip//text//...`, core/checkpoint.py), fp32
  index.npz           the video index (serving.build_video_index layout)
  meta.json           shapes, dtypes manifest, topk, platforms, fingerprint
  bpe_simple_vocab_16e6.txt.gz   the tokenizer's merges (queries tokenize
                      with any CLIP BPE; token ids are the program's input)

Program signature:
  (param leaves in sorted npz-key order, text_ids [Q, W] int32,
   text_mask [Q, W] f32, v_feat [N, F, E] f32, v_mask [N, F] f32)
  -> (values [Q, k] f32, indices [Q, k] int64)
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .core.checkpoint import _atomic_savez, flatten_tree, params_tree
from .core.config import Config

_PROGRAM = "query_program.pt2"
_PARAMS = "params.npz"
_INDEX = "index.npz"
_META = "meta.json"
_SEP = "//"


def _unflatten(keys, leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in zip(keys, leaves):
        node = tree
        *parents, last = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


class _Query(torch.nn.Module):
    """The query computation over the port's model, pinned to the plain
    versions: (ids, mask, v_feat, v_mask) → top-k (values, indices)."""

    def __init__(self, model, topk: int):
        super().__init__()
        self.model, self.topk = model, topk

    def forward(self, text_ids, text_mask, v_feat, v_mask):
        from .models.neighborretr import local_similarity
        t_feat = self.model.get_text_feat(text_ids, text_mask, kernels=False)
        sim = local_similarity(self.model, t_feat, v_feat, text_mask, v_mask,
                               kernels=False)
        vals, idx = torch.topk(sim, self.topk, dim=1, largest=True,
                               sorted=True)
        return vals, idx        # a tuple: topk's named tuple cannot be saved


class _Program(torch.nn.Module):
    """Takes the parameters as inputs in the JAX npz layout, maps them onto
    the port's state dict with torch ops and runs `_Query` on them through
    `torch.func.functional_call`.  The model it calls is kept off the
    module tree, so its own tensors are neither traced nor saved."""

    def __init__(self, model, keys: List[str], topk: int):
        super().__init__()
        self.keys = keys
        object.__setattr__(self, "_query", _Query(model, topk))

    def forward(self, leaves: List[torch.Tensor], text_ids, text_mask,
                v_feat, v_mask):
        from .models import weights_io
        cfg = self._query.model.cfg
        sd = weights_io.state_dict_from_jax_params(
            _unflatten(self.keys, leaves), cfg)
        return torch.func.functional_call(
            self._query, {f"model.{k}": v for k, v in sd.items()},
            (text_ids, text_mask, v_feat, v_mask))


def _sorted_flat(model) -> Tuple[List[str], List[np.ndarray]]:
    """The parameters in the JAX npz layout, keys sorted (the on-disk
    contract: a loader reproduces the input order from params.npz)."""
    flat = flatten_tree(params_tree(model))
    keys = sorted(flat)
    return keys, [flat[k] for k in keys]


def export_query_program(model, cfg: Config, n_videos: int, query_batch: int,
                         topk: int):
    """torch.export the query program at this deployment's shapes, on the
    model's device → torch.export.ExportedProgram."""
    from .models.neighborretr import NeighborRetr
    if topk < 1 or topk > n_videos:
        raise ValueError(f"topk must be in [1, {n_videos}], got {topk}")
    if query_batch < 1:
        raise ValueError(f"query_batch must be >= 1, got {query_batch}")
    m = cfg.model
    dev = model.clip.logit_scale.device
    # the traced model: the port's modules on the meta device
    # (functional_call hands it the program's inputs)
    shell = NeighborRetr(m, device="meta").eval().requires_grad_(False)
    keys, leaves = _sorted_flat(model)
    program = _Program(shell, keys, topk)
    args = ([torch.as_tensor(a, device=dev) for a in leaves],
            torch.zeros((query_batch, m.max_words), dtype=torch.int32,
                        device=dev),
            torch.ones((query_batch, m.max_words), device=dev),
            torch.zeros((n_videos, m.max_frames, m.clip.embed_dim),
                        device=dev),
            torch.ones((n_videos, m.max_frames), device=dev))
    with torch.no_grad():
        ep = torch.export.export(program, args, strict=False)
    ep.example_inputs = None     # torch.export.save would store the weights
    return ep


def save_bundle(bundle_dir: str, model, cfg: Config,
                index: Dict[str, np.ndarray], query_batch: int = 8,
                topk: int = 5) -> str:
    """Export and write a complete deployment bundle directory; the program
    runs on the model's device."""
    from . import serving
    from .data.tokenizer import default_vocab_path

    serving.check_meta(index, cfg, model)
    n_videos = int(index["v_mask"].shape[0])
    program = export_query_program(model, cfg, n_videos, query_batch, topk)
    os.makedirs(bundle_dir, exist_ok=True)
    keys, leaves = _sorted_flat(model)
    dtypes = {k: str(a.dtype) for k, a in zip(keys, leaves)}
    _atomic_savez(os.path.join(bundle_dir, _PARAMS), dict(zip(keys, leaves)))
    _atomic_savez(os.path.join(bundle_dir, _INDEX), index)
    tmp = os.path.join(bundle_dir, "tmp." + _PROGRAM)
    torch.export.save(program, tmp)
    os.replace(tmp, os.path.join(bundle_dir, _PROGRAM))
    vocab = default_vocab_path()
    if vocab and os.path.exists(vocab):
        shutil.copy(vocab, os.path.join(bundle_dir, os.path.basename(vocab)))
    meta = {"query_batch": int(query_batch), "topk": int(topk),
            "n_videos": n_videos, "max_words": int(cfg.model.max_words),
            "platforms": [model.clip.logit_scale.device.type],
            "param_dtypes": dtypes,
            "params_fingerprint": serving.params_fingerprint(model)}
    tmp = os.path.join(bundle_dir, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(bundle_dir, _META))
    return bundle_dir


class Bundle:
    """A loaded bundle: `search_tokens(ids, mask)` → (values, indices).
    Runs on torch and numpy alone: nothing here imports the model or the
    serving layer (tests/test_torch_deploy.py loads a bundle with this
    package blocked)."""

    def __init__(self, program, param_leaves: List[torch.Tensor],
                 v_feat: torch.Tensor, v_mask: torch.Tensor,
                 video_ids: List[str], meta: Dict[str, Any]):
        self._program = program
        self._leaves = param_leaves
        self._v_feat, self._v_mask = v_feat, v_mask
        self.video_ids = video_ids
        self.meta = meta
        self.device = v_feat.device
        self.query_batch = int(meta["query_batch"])
        self.topk = int(meta["topk"])
        self.max_words = int(meta["max_words"])

    def __len__(self) -> int:
        return len(self.video_ids)

    def search_tokens(self, text_ids: np.ndarray, text_mask: np.ndarray,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, W] token ids + mask → ([Q, k] scores, [Q, k] corpus
        indices), Q <= query_batch (shorter batches pad up; the pad rows
        are dropped)."""
        q = text_ids.shape[0]
        if q > self.query_batch:
            raise ValueError(f"got {q} queries; this bundle was exported "
                             f"for query_batch={self.query_batch}")
        ids = np.zeros((self.query_batch, self.max_words), np.int32)
        mask = np.zeros((self.query_batch, self.max_words), np.float32)
        ids[:q] = text_ids
        mask[:q] = text_mask
        with torch.no_grad():
            vals, idx = self._program(
                self._leaves, torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device), self._v_feat,
                self._v_mask)
        return vals[:q].cpu().numpy(), idx[:q].cpu().numpy()


def load_bundle(bundle_dir: str) -> Bundle:
    """Read a bundle with torch.export.load, torch and numpy; the program
    runs on the device it was exported for."""
    with open(os.path.join(bundle_dir, _META)) as f:
        meta = json.load(f)
    dev = torch.device(meta["platforms"][0])
    program = torch.export.load(os.path.join(bundle_dir, _PROGRAM)).module()
    with np.load(os.path.join(bundle_dir, _PARAMS),
                 allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    dtypes = meta["param_dtypes"]
    leaves = [torch.as_tensor(flat[k].astype(dtypes[k]), device=dev)
              for k in sorted(flat)]
    with np.load(os.path.join(bundle_dir, _INDEX),
                 allow_pickle=False) as data:
        index = {k: data[k] for k in data.files}
    v_feat = index["v_feat"].astype(np.float32)
    if "v_scale" in index:   # int8: dequantize (serving.py layout)
        v_feat = v_feat * index["v_scale"].astype(np.float32)[..., None]
    return Bundle(program, leaves, torch.as_tensor(v_feat, device=dev),
                  torch.as_tensor(index["v_mask"].astype(np.float32),
                                  device=dev),
                  [str(v) for v in index["video_ids"]], meta)
