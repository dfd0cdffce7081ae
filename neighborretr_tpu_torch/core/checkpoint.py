"""Checkpointing: parameters + optimizer state + bank + step as a flat-key
npz (↔ neighborretr_tpu/core/checkpoint.py).

The file layout is the JAX package's, key for key: `params//…`, `opt_m//…`,
`opt_v//…` over its parameter pytree (stacked layers, [D, 3, D] in_proj,
input-major linears; models/weights_io.py maps the port's state dict onto it
and back), `bank//ind|feat_t|feat_v|mask_t|mask_v`, `opt_step`, `step`; a
`best.npz` holds the parameter pytree alone.  So a state either package
saves resumes in the other.  bf16 leaves are stored as fp32 (npz has no
portable bf16) and cast back on load.

Single process: the JAX package's per-process sharded saves are not ported.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict

import numpy as np
import torch

from ..models import weights_io
from ..train.bertadam import BertAdamState
from ..train.memory_bank import MemoryBank

_SEP = "//"
Tree = Dict[str, Any]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays/tensors → {`a//b//c`: fp32-or-exact numpy copy}.
    Every leaf is copied: the port updates parameters in place, and a write
    may run on the background thread after the next step began."""
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in tree.items():
        name = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(leaf, dict):
            flat.update(flatten_tree(leaf, name))
            continue
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()      # fp32 holds bf16 exactly
            leaf = leaf.numpy()
        flat[name] = np.array(leaf, copy=True)
    return flat


def unflatten_into(tree_like: Tree, flat: Dict[str, np.ndarray],
                   strict: bool = True):
    """Rebuild a nested dict with tree_like's structure (and its leaves'
    dtypes) from flat arrays.

    strict=False is the warm-start contract: leaves missing from the file
    or with mismatched shapes keep tree_like's values, extra keys are
    ignored, and the diff is returned for logging.  A leaf with the same
    number of elements in another shape is a relayout of the same data and
    is reshaped.  Returns the tree when strict, else (tree, report with
    'missing' / 'mismatched' / 'reshaped' / 'unexpected' key lists)."""
    seen = set()
    missing, mismatched, reshaped = [], [], []

    def build(like: Tree, prefix: str) -> Tree:
        out: Tree = {}
        for key, leaf in like.items():
            name = f"{prefix}{_SEP}{key}" if prefix else str(key)
            if isinstance(leaf, dict):
                out[key] = build(leaf, name)
                continue
            seen.add(name)
            leaf = np.asarray(leaf)
            if name not in flat:
                if strict:
                    raise KeyError(f"checkpoint missing leaf: {name}")
                missing.append(name)
                out[key] = leaf
                continue
            arr = flat[name]
            if arr.shape != leaf.shape:
                if arr.size == leaf.size:
                    reshaped.append(f"{name} (ckpt {arr.shape} → model "
                                    f"{leaf.shape})")
                    arr = arr.reshape(leaf.shape)
                else:
                    if strict:
                        raise ValueError(f"shape mismatch for {name}: ckpt "
                                         f"{arr.shape} vs model {leaf.shape}")
                    mismatched.append(f"{name} (ckpt {arr.shape} vs model "
                                      f"{leaf.shape})")
                    out[key] = leaf
                    continue
            out[key] = arr.astype(leaf.dtype)
        return out

    tree = build(tree_like, "")
    if strict:
        return tree
    return tree, {"missing": missing, "mismatched": mismatched,
                  "reshaped": reshaped, "unexpected": sorted(set(flat) - seen)}


def _atomic_savez(path: str, payload: Dict[str, np.ndarray]) -> None:
    """np.savez via temp file + rename: a crash mid-write can never leave a
    truncated npz at the real path; the previous file survives until the
    new one is complete."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        # a file object, not a name: np.savez would append '.npz' to a name
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


class AsyncWriter:
    """Single background checkpoint writer.

    `submit(fn)` returns immediately; `fn` (a closure over host copies)
    runs on a daemon thread in submission order, so the npz serialisation
    and the disk write overlap the next training steps.  `wait()` drains
    the queue and re-raises the first error: call it before reading any
    file a submitted write produces, and at teardown."""

    def __init__(self):
        import queue
        import threading
        # maxsize=1: at most one queued + one in-flight write, so a slow
        # disk bounds the extra host memory to about one state copy
        self._q = queue.Queue(maxsize=1)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def _run(self):
        import logging
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                # every write is attempted: a transient failure must not
                # silently drop all later checkpoints
                fn()
            except BaseException as e:   # first error surfaced by wait()
                logging.getLogger("neighborretr_tpu_torch").exception(
                    "background checkpoint write failed")
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def submit(self, fn) -> None:
        if not self._thread.is_alive():
            fn()        # writer gone (interpreter teardown): write in line
            return
        self._q.put(fn)

    def wait(self) -> None:
        """Block until every submitted write finished; re-raise failures."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=60)


def params_tree(model) -> Tree:
    """The model's parameters as the JAX package's pytree (numpy fp32)."""
    return weights_io.to_jax_params(model.state_dict(), model.cfg)


def load_tree_into_model(model, tree: Tree) -> None:
    """Copy a JAX-layout parameter pytree into the model, in place."""
    sd = weights_io.state_dict_from_jax_params(tree, model.cfg)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            p.copy_(torch.as_tensor(sd[name]))


def save_params(path: str, params) -> None:
    """params: a model, or its JAX-layout pytree (`params_tree`)."""
    tree = params if isinstance(params, dict) else params_tree(params)
    _atomic_savez(path, flatten_tree(tree))


def load_params(path: str, params_like: Tree, strict: bool = True):
    """strict=True → pytree; strict=False → (pytree, report).  Takes a
    parameters-only npz (best.npz) and a full train-state npz
    (state_epochN.npz), whose `params//` subtree is extracted."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    prefix = f"params{_SEP}"
    if "opt_step" in flat and any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    return unflatten_into(params_like, flat, strict=strict)


def latest_resumable(output_dir: str):
    """Newest resumable train state in output_dir, or None: scans
    state_preempt.npz and state_epoch*.npz and returns the path whose saved
    `step` is highest (ties prefer the preempt file).  Unreadable candidates
    are skipped.  Powers `--resume auto`."""
    candidates = sorted(glob.glob(os.path.join(output_dir, "state_epoch*.npz")))
    candidates.append(os.path.join(output_dir, "state_preempt.npz"))
    best_path, best_step = None, -1
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            with np.load(path, allow_pickle=False) as data:
                step = int(data["step"])
        except Exception:
            continue
        if step >= best_step:
            best_path, best_step = path, step
    return best_path


def _moments_tree(moments: Dict[str, torch.Tensor], cfg) -> Tree:
    """Adam moments (keyed like the state dict) in the JAX layout: the map
    is a permutation of entries, so it holds for m and for v."""
    return weights_io.to_jax_params(moments, cfg)


def train_state_payload(state) -> Dict[str, np.ndarray]:
    """Host copy of a train/step.py::TrainState in the npz key layout.
    Taken synchronously (parameters change in place at the next step); the
    write itself may then run in the background (`_atomic_savez`)."""
    cfg = state.model.cfg
    payload: Dict[str, np.ndarray] = {}
    for name, tree in (("params", params_tree(state.model)),
                       ("opt_m", _moments_tree(state.opt.m, cfg)),
                       ("opt_v", _moments_tree(state.opt.v, cfg)),
                       ("bank", state.bank._asdict())):
        payload.update(flatten_tree(tree, name))
    payload["opt_step"] = np.asarray(state.opt.step, np.int32)
    payload["step"] = np.asarray(state.step, np.int32)
    return payload


def save_train_state(path: str, state) -> None:
    _atomic_savez(path, train_state_payload(state))


def load_train_state(path: str, state_like):
    """Read a train-state npz (from either package) into `state_like`'s
    model in place and return the TrainState with the file's optimizer
    state, bank and step, on the model's device and in `state_like`'s
    dtypes."""
    from ..train.step import TrainState

    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    model = state_like.model
    cfg = model.cfg

    def sub(prefix: str) -> Dict[str, np.ndarray]:
        plen = len(prefix) + len(_SEP)
        return {k[plen:]: v for k, v in flat.items()
                if k.startswith(prefix + _SEP)}

    like = params_tree(model)
    load_tree_into_model(model, unflatten_into(like, sub("params")))

    def moments(prefix: str, old: Dict[str, torch.Tensor]):
        sd = weights_io.state_dict_from_jax_params(
            unflatten_into(like, sub(prefix)), cfg)
        return {n: torch.as_tensor(sd[n]).to(device=t.device, dtype=t.dtype)
                for n, t in old.items()}

    opt = BertAdamState(step=int(flat["opt_step"]),
                        m=moments("opt_m", state_like.opt.m),
                        v=moments("opt_v", state_like.opt.v))
    bank_flat = sub("bank")
    bank = MemoryBank(**{
        k: torch.as_tensor(bank_flat[k]).to(device=v.device, dtype=v.dtype)
        for k, v in state_like.bank._asdict().items()})
    return TrainState(model=model, opt=opt, bank=bank, step=int(flat["step"]))
