"""Epoch orchestration: bank fill → train epoch → eval → best tracking
(↔ neighborretr_tpu/train/loop.py), on one device or on a data group of
one process per device (parallel/mesh.py).

The weights start seeded random, then take the OpenAI CLIP checkpoint of
`train.clip_checkpoint` (the temporal tower re-seeded from its text tower),
then the `train.init_checkpoint` warm start (strict=False: either package's
npz, or a reference-trained torch checkpoint), as in the JAX loop.

Per epoch the memory bank is re-filled from `mb_batch` training batches
over an empty bank, the train epoch runs with loss logging every `n_display`
steps and a mid-epoch validation every `n_display*3` steps (and after the
first step), then the per-epoch eval updates the best metrics and
`best.npz`, and `state_epochN.npz` holds the full train state.  A resumed
run continues exactly: the loader's seeded plan is fast-forwarded, the
checkpointed bank is kept mid-epoch, the optimizer schedule reads the saved
step, and each step's DPC-KNN tie-break draws come from a generator seeded
from (run seed, global step).  SIGTERM saves `state_preempt.npz` at the
next step boundary.  Under `--augment_backend device` the RandAugment draws
come from generators seeded from (run seed, global step) for a step and
(run seed, epoch, fill index) for a bank-fill batch, so a resume replays
them too.

On a mesh every data rank loads its block of each train, bank and test
batch (the loader's process_index / process_count are the data coordinates:
a tensor-parallel or pipeline mesh's other ranks load the same block), logs
only on rank 0, and rank 0 alone writes best.npz, state_epochN.npz and the
tracker json, full and in the JAX layout whatever the placement (on a
sharded one every rank takes part in the gathers); the tracker of a
resumed run is rank 0's, broadcast.  The parameters are placed
(parallel/mesh.py::place_params: replicated, FSDP2 under `train.fsdp`,
the Megatron split and stage slices by the mesh's axes) after the CLIP and
warm-start weights are loaded, and a resumed state loads under any
placement.  A SIGTERM that any
rank catches stops every rank at the same step boundary (a MAX all-reduce
of the stop flag), and each rank then writes its file of the sharded
preempt set (`state_preempt.shard{p}.npz` + `state_preempt.manifest.json`,
core/checkpoint.py), which `--resume` takes by its manifest.

Not ported: the device prefetch (batches are moved when the step wants
them).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
from typing import Optional

import torch

from ..core import checkpoint as ckpt
from ..core.config import Config
from ..data.loader import BatchLoader
from ..models import weights_io
from ..parallel import mesh as pmesh
from ..utils.logging import JsonlMetricsWriter, MetricLogger, setup_logger
from . import memory_bank as mb
from .evaluate import evaluate
from .metrics import BestMetricsTracker
from .step import (TrainState, create_train_state, fill_bank_step, to_device,
                   train_step)


class PreemptionGuard:
    """SIGTERM → checkpoint-and-exit at the next step boundary: schedulers
    send SIGTERM before they evict a job, and saving the full train state
    turns the eviction into a resumable pause (`--resume auto`).  No-op
    outside the main thread (signal handlers cannot be set there)."""

    def __init__(self, enabled: bool = True):
        self.requested = False
        self.enabled = enabled
        self._prev = None
        self._installed = False

    def __enter__(self):
        if self.enabled:
            import signal
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_signal)
                self._installed = True
            except ValueError:          # not the main thread
                self.enabled = False
        return self

    def _on_signal(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        if self._installed:
            import signal
            # _prev is None when the earlier handler was installed outside
            # Python; SIG_DFL is the closest thing that can be restored
            signal.signal(signal.SIGTERM, self._prev if self._prev is not None
                          else signal.SIG_DFL)
            self._installed = False
        return False


def step_generator(seed: int, global_step: int, device) -> torch.Generator:
    """The generator of one step's DPC-KNN tie-break draws: a function of
    (run seed, global step) alone, so a resumed run replays them."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + global_step) % (2 ** 63))
    return gen


def augment_generator(device, *position: int) -> torch.Generator:
    """The generator of one batch's device-augment draws, a function of
    `position` alone: (run seed, global step) for a train step, (run seed,
    epoch, fill index) for a bank-fill batch.  Hashed, so its streams are
    disjoint from `step_generator`'s and from each other."""
    key = "device-augment " + " ".join(map(str, position))
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed >> 1)
    return gen


_BANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _empty_bank(cfg: Config, device) -> mb.MemoryBank:
    return mb.create(cfg.train.memory_bank_capacity, cfg.model.max_words,
                     cfg.model.max_frames, cfg.model.clip.embed_dim,
                     feat_dtype=_BANK_DTYPES[cfg.train.bank_dtype],
                     device=device)


def fill_memory_bank(model, cfg: Config, bank_loader: BatchLoader,
                     bank: mb.MemoryBank, device, kernels: bool = True,
                     epoch: int = 0, mesh=None) -> mb.MemoryBank:
    """Epoch-start fill: encode min(mb_batch, len(loader)) batches, each
    augmented on the device under --augment_backend device; on a data group
    each rank encodes its rows of every batch."""
    n_fill = min(cfg.train.mb_batch, len(bank_loader))
    on_device = cfg.data.augment_backend == "device"
    for i, batch in enumerate(itertools.islice(iter(bank_loader), n_fill)):
        gen = (augment_generator(device, cfg.train.seed, epoch, i)
               if on_device else None)
        bank = fill_bank_step(model, bank, to_device(batch, device), cfg,
                              i * cfg.train.batch_size, kernels, gen, mesh)
    return bank


def run_training(cfg: Config, train_ds, test_ds, logger=None, device=None,
                 workers: Optional[int] = None, kernels: bool = True,
                 mesh: Optional[pmesh.DataGroup] = None):
    """Full training run on `device` (default: the data group's device, else
    the CUDA device) → (final TrainState, BestMetricsTracker).  mesh: the
    data group; every rank calls this with the same arguments."""
    mesh = mesh if mesh is not None else pmesh.DataGroup(
        device=torch.device(device if device is not None else "cuda"))
    device = torch.device(device) if device is not None else mesh.device
    main = mesh.rank == 0
    logger = logger or setup_logger(output_dir=cfg.train.output_dir,
                                    is_main=main)
    workers = workers if workers is not None else cfg.data.workers

    mode = dict(worker_mode=cfg.data.worker_mode,
                process_index=mesh.dp_rank, process_count=mesh.dp_size)
    train_loader = BatchLoader(train_ds, cfg.train.batch_size, shuffle=True,
                               drop_last=True, workers=workers,
                               seed=cfg.train.seed, **mode)
    bank_loader = BatchLoader(train_ds, cfg.train.batch_size, shuffle=True,
                              drop_last=True, workers=workers,
                              seed=cfg.train.seed + 7919, **mode)
    test_loader = BatchLoader(test_ds, cfg.train.batch_size_val,
                              shuffle=False, drop_last=False,
                              workers=workers, pad_to_batch=True, **mode)

    steps_per_epoch = len(train_loader)
    t_total = max(steps_per_epoch * cfg.train.epochs, 1)

    model = weights_io.init_model(cfg.model, cfg.train.seed, device)
    if cfg.train.clip_checkpoint:
        weights_io.load_openai_clip_into(model, cfg.train.clip_checkpoint)
        logger.info("Loaded CLIP weights from %s", cfg.train.clip_checkpoint)
    if cfg.train.init_checkpoint:
        # strict=False warm start (the reference's --init_model,
        # main.py:60-66): an npz loads partially with the diff logged, a
        # torch checkpoint takes the reference path
        weights_io.load_model_checkpoint(model, cfg.train.init_checkpoint,
                                         strict=False, logger=logger)
        logger.info("Warm-started from %s", cfg.train.init_checkpoint)
    pmesh.place_params(model, mesh, fsdp=cfg.train.fsdp)

    state = create_train_state(model, _empty_bank(cfg, device),
                               moments_dtype=cfg.optim.moments_dtype)
    tracker = BestMetricsTracker()
    global_step = 0
    start_epoch = 0
    resume_skip = 0       # batches of start_epoch consumed before the resume

    if cfg.train.resume_checkpoint:
        path = cfg.train.resume_checkpoint
        state = (ckpt.load_sharded_train_state(path, state)
                 if path.endswith(ckpt.MANIFEST_SUFFIX)
                 else ckpt.load_train_state(path, state))
        global_step = state.step
        start_epoch = min(global_step // max(steps_per_epoch, 1),
                          cfg.train.epochs)
        resume_skip = global_step - start_epoch * steps_per_epoch
        logger.info("Resumed from %s at step %d (epoch %d%s)",
                    cfg.train.resume_checkpoint, global_step, start_epoch,
                    f", batch {resume_skip}" if resume_skip else "")
        # without the tracker the first eval after the resume would
        # overwrite best.npz with parameters worse than the earlier best.
        # Rank 0's view on every rank: tracker.update gates collectives
        tracker_path = os.path.join(cfg.train.output_dir, "best_metrics.json")
        if main and os.path.exists(tracker_path):
            with open(tracker_path) as f:
                tracker.load_dict(json.load(f))
        tracker.load_dict(pmesh.broadcast_object(tracker.to_dict(), mesh))
        if tracker.best_mean_r1 > 1e-5:
            logger.info("Restored best-metrics tracker (mean R@1 %.2f)",
                        tracker.best_mean_r1)

    jsonl = JsonlMetricsWriter(cfg.train.output_dir, enabled=main)
    guard = PreemptionGuard(
        enabled=cfg.train.save_checkpoints and cfg.train.save_on_preempt)
    # npz writes run on a background thread over host copies, so the step
    # loop never waits for the disk; every read-back below waits first
    writer = ckpt.AsyncWriter() if cfg.train.save_checkpoints else None
    best_path = os.path.join(cfg.train.output_dir, "best.npz")
    try:
        with guard:
            state, best_flat, preempted = _train_epochs(
                cfg, state, tracker, guard, train_loader, bank_loader,
                test_loader, test_ds, logger, device, t_total,
                steps_per_epoch, start_epoch, global_step, best_path, jsonl,
                writer, resume_skip, kernels, mesh)
        if preempted:
            return state, tracker
        if writer is not None:
            writer.wait()      # surface write errors; best.npz is readable

        # final test on the best weights: this run's own best (every rank
        # holds it), or after a one-process resume the best.npz that
        # predates it (several processes cannot all count on reading it)
        if cfg.train.save_checkpoints:
            like = ckpt.params_tree(model)
            best = None
            if best_flat is not None:
                best = ckpt.unflatten_into(like, best_flat)
            elif mesh.world == 1 and os.path.exists(best_path):
                best = ckpt.load_params(best_path, like)
            if best is not None:
                final = [pmesh.local(p).detach().clone()
                         for p in model.parameters()]
                ckpt.load_tree_into_model(model, best)
                logger.info("Final test on best checkpoint:")
                evaluate(model, cfg, test_loader, dataset=test_ds,
                         logger=logger, kernels=kernels, mesh=mesh)
                with torch.no_grad():
                    for p, t in zip(model.parameters(), final):
                        pmesh.local(p).copy_(t)
        return state, tracker
    finally:
        if writer is not None:
            try:
                writer.close()
            except Exception:
                logger.exception("background checkpoint write failed")


def _train_epochs(cfg, state: TrainState, tracker, guard, train_loader,
                  bank_loader, test_loader, test_ds, logger, device, t_total,
                  steps_per_epoch, start_epoch, global_step, best_path, jsonl,
                  writer, resume_skip, kernels, mesh):
    """The epoch loop → (state, flat host copy of the best parameters or
    None, preempted); returns early, with the preempt state saved, when a
    rank's guard caught SIGTERM."""
    model = state.model
    out_dir = cfg.train.output_dir
    best_flat = None
    cuda = device.type == "cuda"
    main = mesh.rank == 0
    sharded = pmesh.placement_of(model) is not None

    def stop():
        """Whether any rank caught SIGTERM: the same answer on every rank,
        at the same point of the loop."""
        return pmesh.any_rank(guard.requested, mesh)

    def save_best(flat):
        """best.npz, then best_metrics.json, in one submitted closure: the
        json claims a best only once it is on disk.  The tracker's state is
        captured now, so a later update cannot leak into this write."""
        if not main:
            return
        tracker_dict = tracker.to_dict()
        best_r1 = tracker.best_mean_r1

        def write():
            ckpt._atomic_savez(best_path, flat)
            with open(os.path.join(out_dir, "best_metrics.json"), "w") as f:
                json.dump(tracker_dict, f)
            logger.info("Saved best checkpoint (mean R@1 %.2f)", best_r1)

        writer.submit(write)

    def eval_and_track(epoch):
        """evaluate → jsonl → best tracking → best save: the one sequence
        behind the mid-epoch and the per-epoch validations."""
        nonlocal best_flat
        t2v, v2t = evaluate(model, cfg, test_loader, dataset=test_ds,
                            logger=logger, kernels=kernels, mesh=mesh)
        jsonl.write(kind="eval", step=global_step, epoch=epoch,
                    t2v={k: float(v) for k, v in t2v.items()},
                    v2t={k: float(v) for k, v in v2t.items()})
        if tracker.update(t2v, v2t) and cfg.train.save_checkpoints:
            best_flat = ckpt.flatten_tree(ckpt.params_tree(model))
            save_best(best_flat)

    profiler = None     # across epochs: a window may span an epoch boundary

    def stop_profiler(reason):
        nonlocal profiler
        if profiler is not None:
            if cuda:
                torch.cuda.synchronize(device)
            profiler.stop()
            os.makedirs(cfg.train.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(cfg.train.profile_dir, "trace.json"))
            logger.info("Profiler trace written to %s (%s)\n%s",
                        cfg.train.profile_dir, reason,
                        profiler.key_averages().table(
                            sort_by="cuda_time_total" if cuda
                            else "cpu_time_total", row_limit=25))
            profiler = None

    def preempt_exit():
        stop_profiler("stopped on preemption")
        if mesh.world > 1:
            path = ckpt.save_sharded_train_state(out_dir, state, mesh=mesh)
            logger.info("Preemption signal caught: saved this process's "
                        "part of the sharded state set to %s (continue with "
                        "--resume auto)", path)
        else:
            path = os.path.join(out_dir, "state_preempt.npz")
            ckpt.save_train_state(path, state)
            logger.info("Preemption signal caught: saved resumable "
                        "TrainState to %s (continue with --resume auto)", path)
        return state, best_flat, True

    for epoch in range(start_epoch, cfg.train.epochs):
        train_loader.set_epoch(epoch)
        bank_loader.set_epoch(epoch)
        skip = resume_skip if epoch == start_epoch else 0

        if skip:
            # exact mid-epoch continuation: the checkpointed bank holds this
            # epoch's fill plus the consumed steps' FIFO pushes; the loader
            # plan is a function of (seed, epoch) and is fast-forwarded
            train_loader.skip_next_batches(skip)
            logger.info("Epoch %d: exact mid-epoch resume at batch %d/%d "
                        "(bank kept from the checkpoint)", epoch, skip,
                        steps_per_epoch)
        else:
            tic = time.time()
            # over an EMPTY bank: an epoch-boundary resume state carries the
            # previous epoch's rows (state_epochN is saved before the
            # clear), and a fill shorter than the capacity would leave them
            state.bank = fill_memory_bank(model, cfg, bank_loader,
                                          _empty_bank(cfg, device), device,
                                          kernels, epoch, mesh)
            if cuda:
                torch.cuda.synchronize(device)
            logger.info("Epoch %d: memory bank filled in %.1fs", epoch,
                        time.time() - tic)
        if stop():                   # SIGTERM during the bank fill
            return preempt_exit()

        meters = MetricLogger()
        epoch_tic = time.time()
        # host time blocked in next(): ~0 means the loader keeps up
        data_wait = [0.0]

        def timed(src):
            it_ = iter(src)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it_)
                except StopIteration:
                    return
                data_wait[0] += time.perf_counter() - t0
                yield b

        data_wait_logged = 0.0
        # `it` is the absolute in-epoch batch index, so the display and
        # mid-epoch-eval cadence line up with the uninterrupted run
        for it, batch in enumerate(timed(train_loader), start=skip):
            if (main and cfg.train.profile_dir and profiler is None
                    and global_step == cfg.train.profile_steps[0]):
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else [])
                profiler = profile(activities=acts)
                profiler.start()
            gen = (step_generator(cfg.train.seed, global_step, device)
                   if cfg.model.cluster_noise else None)
            aug = (augment_generator(device, cfg.train.seed, global_step)
                   if cfg.data.augment_backend == "device" else None)
            state, metrics = train_step(state, to_device(batch, device), cfg,
                                        t_total, gen, kernels, aug, mesh)
            global_step += 1
            if stop():
                return preempt_exit()
            if profiler is not None and \
                    global_step >= cfg.train.profile_steps[1]:
                stop_profiler(f"steps {cfg.train.profile_steps[0]}-"
                              f"{global_step}")

            if (it % cfg.train.n_display) == 0:
                # sampling on purpose: reading the scalars waits for the
                # device, so the meters average every n_display-th step.
                # One transfer for all of them
                names = [k for k, v in metrics.items() if v.ndim == 0]
                values = torch.stack([metrics[k].float() for k in names]
                                     ).tolist()
                scalars = dict(zip(names, values))
                scalars["data_wait_s"] = data_wait[0] - data_wait_logged
                data_wait_logged = data_wait[0]
                meters.update(**scalars)
                jsonl.write(kind="train", step=global_step, epoch=epoch,
                            **{k: round(v, 6) for k, v in scalars.items()})
                done = it + 1
                eta = ((time.time() - epoch_tic) / max(done - skip, 1)
                       * (steps_per_epoch - done))
                logger.info("Epoch %d/%d step %d/%d  %s  eta %.0fs",
                            epoch + 1, cfg.train.epochs, done,
                            steps_per_epoch, meters, eta)
                if cuda and it % (cfg.train.n_display * 5) == 0:
                    logger.info(
                        "Device memory: peak %.2f GB of %.2f GB",
                        torch.cuda.max_memory_allocated(device) / 2 ** 30,
                        torch.cuda.get_device_properties(device).total_memory
                        / 2 ** 30)

            # mid-epoch validation: every n_display*3 steps and once near
            # the start, but not on the epoch's final step, where the
            # per-epoch eval would repeat it on unchanged parameters
            if cfg.train.mid_epoch_eval and it != steps_per_epoch - 1 and (
                    global_step % (cfg.train.n_display * 3) == 0
                    or global_step == 1):
                eval_and_track(epoch)
                if stop():
                    return preempt_exit()

        eval_and_track(epoch)
        # a sharded state is gathered by every rank; rank 0 writes it
        if cfg.train.save_checkpoints and (main or sharded):
            payload = ckpt.train_state_payload(state)
            if main:
                writer.submit(lambda p=payload, e=epoch: ckpt._atomic_savez(
                    os.path.join(out_dir, f"state_epoch{e}.npz"), p))
        if stop():              # SIGTERM during the eval or the checkpoint
            return preempt_exit()
        # epoch-end bank clear: re-filled next epoch
        state.bank = _empty_bank(cfg, device)

    stop_profiler("stopped at end of training")
    return state, best_flat, False
