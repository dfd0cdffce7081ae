"""Checkpointing: parameters + optimizer state + bank + step as a flat-key
npz (↔ neighborretr_tpu/core/checkpoint.py).

The file layout is the JAX package's, key for key: `params//…`, `opt_m//…`,
`opt_v//…` over its parameter pytree (stacked layers, [D, 3, D] in_proj,
input-major linears; models/weights_io.py maps the port's state dict onto it
and back), `bank//ind|feat_t|feat_v|mask_t|mask_v`, `opt_step`, `step`; a
`best.npz` holds the parameter pytree alone.  So a state either package
saves resumes in the other.  bf16 leaves are stored as fp32 (npz has no
portable bf16) and cast back on load.

On a model-sharded placement (parallel/mesh.py::place_params: FSDP2, the
Megatron split, the stage slices) every file holds full leaves in the JAX
layout: the parameters and moments are gathered first (`gather_full`, a
collective every rank calls), and a load takes each rank's part of them
(`local_piece`), so a state resumes under any placement, in either
package.  FSDP2's dim-0 chunk of a [3D, D] matrix is no box of the JAX
[D, 3, D] layout, so no shard is written as it lies.

A run of several processes (one per device, parallel/mesh.py) saves its
preemption state as the JAX package's per-process sharded set:
`{tag}.shard{p}.npz` per process and `{tag}.manifest.json` from process 0.
Process 0 writes every leaf under the `full//` keys and the others the
step; a sharded state is gathered first (the ranks stop together at a step
boundary, so the gathers can run).  A set the JAX package wrote with
sharded leaves (`shape//`, `shdata//`, `shidx//`) is reassembled.  Sets
cross both ways.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import weights_io
from ..parallel import mesh as pmesh
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
        flat[name] = pmesh.fetch_to_host(leaf)
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
    """The model's full parameters as the JAX package's pytree (numpy
    fp32); gathered on a sharded placement (every rank calls it then)."""
    return weights_io.to_jax_params(pmesh.full_state_dict(model), model.cfg)


def load_tree_into_model(model, tree: Tree) -> None:
    """Copy a JAX-layout parameter pytree into the model, in place (each
    rank's part on a sharded placement)."""
    pmesh.load_full_state_dict(
        model, weights_io.state_dict_from_jax_params(tree, model.cfg))


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
    state_preempt.npz, state_epoch*.npz and a complete sharded preempt set
    (its manifest) and returns the path whose saved `step` is highest
    (ties prefer the preempt saves).  Unreadable candidates are skipped.
    Powers `--resume auto`."""
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
    mpath = os.path.join(output_dir, "state_preempt" + MANIFEST_SUFFIX)
    if os.path.exists(mpath):
        got = _read_sharded_set(mpath, materialize=False)
        if got is not None and got[0] >= best_step:
            best_path, best_step = mpath, got[0]
    return best_path


def resolve_resume_auto(output_dir: str,
                        mesh: Optional[pmesh.DataGroup] = None):
    """`--resume auto` on a data group: process 0 resolves
    `latest_resumable` and every process takes its decision (the file name,
    joined to its own output_dir), so no rank resumes from another state
    than the others."""
    mesh = mesh if mesh is not None else pmesh.DataGroup()
    path = latest_resumable(output_dir) if mesh.rank == 0 else None
    name = pmesh.broadcast_object(os.path.basename(path) if path else None,
                                  mesh)
    return os.path.join(output_dir, name) if name else None


def _moments_tree(moments: Dict[str, torch.Tensor], model) -> Tree:
    """Adam moments (keyed like the state dict) in the JAX layout, gathered
    on a sharded placement: the map is a permutation of entries, so it
    holds for m and for v."""
    placement = pmesh.placement_of(model)
    if placement is not None:
        moments = pmesh.gather_full(moments, placement)
    return weights_io.to_jax_params(moments, model.cfg)


def train_state_payload(state) -> Dict[str, np.ndarray]:
    """Host copy of a train/step.py::TrainState in the npz key layout.
    Taken synchronously (parameters change in place at the next step); the
    write itself may then run in the background (`_atomic_savez`)."""
    payload: Dict[str, np.ndarray] = {}
    for name, tree in (("params", params_tree(state.model)),
                       ("opt_m", _moments_tree(state.opt.m, state.model)),
                       ("opt_v", _moments_tree(state.opt.v, state.model)),
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
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _train_state_from_flat(flat, state_like)


def _train_state_from_flat(flat: Dict[str, np.ndarray], state_like):
    from ..train.step import TrainState

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
        return pmesh.local_like(sd, old, pmesh.placement_of(model))

    opt = BertAdamState(step=int(flat["opt_step"]),
                        m=moments("opt_m", state_like.opt.m),
                        v=moments("opt_v", state_like.opt.v))
    bank_flat = sub("bank")
    bank = MemoryBank(**{
        k: torch.as_tensor(bank_flat[k]).to(device=v.device, dtype=v.dtype)
        for k, v in state_like.bank._asdict().items()})
    return TrainState(model=model, opt=opt, bank=bank, step=int(flat["step"]))


# ---------------------------------------------------------------------------
# Per-process sharded train states (↔ the JAX package's sharded preempt
# saves): collective-free, so a process can write its file from a
# signal-initiated stop without waiting for the others.
# ---------------------------------------------------------------------------

MANIFEST_SUFFIX = ".manifest.json"


def save_sharded_train_state(output_dir: str, state,
                             tag: str = "state_preempt",
                             mesh: Optional[pmesh.DataGroup] = None) -> str:
    """Every process of the mesh calls this; each writes
    `{tag}.shard{rank}.npz`, process 0 also `{tag}.manifest.json`.  Process
    0's file holds every leaf under `full//` (the JAX package's key for a
    replicated leaf) and the others hold the step only; a sharded state is
    first gathered, a collective every process joins.  Shard files of an
    earlier, larger group are removed.  Returns this process's shard
    path."""
    mesh = mesh if mesh is not None else pmesh.DataGroup()
    payload: Dict[str, np.ndarray] = {}
    if mesh.rank == 0 or pmesh.placement_of(state.model) is not None:
        full = train_state_payload(state)
        if mesh.rank == 0:
            payload = {f"full{_SEP}{k}": v for k, v in full.items()
                       if _SEP in k}
    payload["opt_step"] = np.asarray(state.opt.step, np.int32)
    payload["step"] = np.asarray(state.step, np.int32)
    payload["process_count"] = np.asarray(mesh.world, np.int64)
    shard_path = os.path.join(output_dir, f"{tag}.shard{mesh.rank}.npz")
    _atomic_savez(shard_path, payload)
    if mesh.rank == 0:
        mpath = os.path.join(output_dir, tag + MANIFEST_SUFFIX)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tag": tag, "step": int(state.step),
                       "process_count": mesh.world}, f)
        os.replace(tmp, mpath)
        for fp in glob.glob(os.path.join(output_dir, f"{tag}.shard*.npz")):
            m = re.fullmatch(re.escape(tag) + r"\.shard(\d+)\.npz",
                             os.path.basename(fp))
            if m and int(m.group(1)) >= mesh.world:
                os.remove(fp)
    return shard_path


def _read_sharded_set(manifest_path: str, materialize: bool = True):
    """(step, flat dict of the reassembled global arrays) of a sharded set,
    or None when the set is incomplete or inconsistent (a missing shard
    file, processes at different steps, shards that do not tile an array
    exactly once).  materialize=False checks the set without reading any
    array data (npz members load lazily)."""
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        tag = manifest["tag"]
        pcount = int(manifest["process_count"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    out_dir = os.path.dirname(manifest_path)
    files = [os.path.join(out_dir, f"{tag}.shard{i}.npz")
             for i in range(pcount)]
    if pcount < 1 or not all(os.path.exists(fp) for fp in files):
        return None
    flat: Dict[str, np.ndarray] = {}
    shapes: Dict[str, np.ndarray] = {}
    pieces: Dict[str, list] = {}
    steps = set()
    try:
        for fp in files:
            with np.load(fp, allow_pickle=False) as data:
                steps.add(int(data["step"]))
                if int(data["process_count"]) != pcount:
                    return None
                for k in data.files:
                    kind, _, rest = k.partition(_SEP)
                    if kind == "full":
                        if materialize:
                            flat[rest] = data[k]
                    elif kind == "shape":
                        shapes[rest] = data[k]
                    elif kind == "shdata":
                        base = rest.rsplit("@", 1)[0]
                        pieces.setdefault(base, []).append(
                            (data[f"shidx{_SEP}{rest}"],
                             data[k] if materialize else None))
                    elif kind != "shidx" and materialize:
                        flat[k] = data[k]       # step, opt_step
    except (OSError, ValueError, KeyError):
        return None
    if len(steps) != 1:
        return None
    for key, shape in shapes.items():
        parts = pieces.get(key, [])
        size = int(np.prod([int(d) for d in shape], dtype=np.int64))
        covered, buf = 0, None
        for bounds, arr in parts:
            covered += int(np.prod([int(b) - int(a) for a, b in bounds],
                                   dtype=np.int64))
            if materialize:
                if buf is None:
                    buf = np.zeros(tuple(int(d) for d in shape), arr.dtype)
                buf[tuple(slice(int(a), int(b)) for a, b in bounds)] = arr
        if not parts or covered != size:
            return None
        if materialize:
            flat[key] = buf
    flat.pop("process_count", None)
    return steps.pop(), (flat if materialize else None)


def load_sharded_train_state(manifest_path: str, state_like):
    """Resume from a sharded set (the path of its manifest): the global
    arrays reassembled from every process's file, then read as
    `load_train_state` reads one npz."""
    got = _read_sharded_set(manifest_path)
    if got is None:
        raise ValueError(
            f"sharded checkpoint at {manifest_path} is incomplete or "
            "inconsistent (missing shard files or skewed steps)")
    return _train_state_from_flat(got[1], state_like)
