"""Training cells: the program's `train_step` back to back over a pool of
batches, after the epoch-start bank fill.

Set-up builds one train state (the benchmark's weights, zero moments, the
bank filled by `fill_bank_step` from the pool), takes its first
`check_steps` steps through the same call and the same pool the window
uses (on distinct batches, so they also warm every shape), and reads what
the check needs: each step's loss, the first step's gradient as BertAdam
took it (its first moment over 1 - b1), each leaf's change and the bank
the steps leave, and for the similarity stage the first step's features
(the bank's head after it), the bank before it and the bank centralities
its loss computed (recorded from `models.neighborretr.bank_centrality`).
The window then issues steps until `--seconds` have passed on the host's clock, with
no synchronisation but the program's own, and ends at a synchronise:
pairs/s = steps x batch / (that synchronise - the window's start).  A step
whose loss terms are not all finite is failed.

Once the window has closed and the peak memory has been read, the program's
state is freed and the reference (reference/train.py, float32, TF32 off)
fills its bank from the same inputs made again from the seed and takes the
same steps from the same weights, cluster draws and bank; it also works
out the first step's bank centralities in float64 from the program's own
features and bank (the similarity family alone, past the towers, whose
bf16 rounding would hide a lower-precision similarity in the whole
step's numbers).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Optional

import torch

from ..counts.flops import step_flops
from ..harness import compare, core, port, readers, trace
from ..reference import train as RT
from ..reference.precision import Precision, set_float32_exact

LOSS_TERMS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
              "kl_loss")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(step, fault: Optional[str]):
    """The train step with a planted fault (the check's own tests)."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(state, batch, *a, **k):
            keep = [t.detach().clone() for t in _state_tensors(state)]
            _, met = step(state, batch, *a, **k)
            with torch.no_grad():
                for t, s in zip(_state_tensors(state), keep):
                    t.copy_(s)
            return state, met
        return unchanged
    if fault == "half_batch":
        def half(state, batch, *a, **k):
            B = batch["text_ids"].shape[0]
            return step(state, {n: v[:B // 2] for n, v in batch.items()},
                        *a, **k)
        return half
    raise ValueError(f"unknown fault {fault!r}")


def _state_tensors(state):
    return ([p for p in state.model.parameters()]
            + list(state.opt.m.values()) + list(state.opt.v.values()))


@contextlib.contextmanager
def centralities_recorded(enabled: bool):
    """While enabled, the program's bank centralities (the mean similarity
    of each text against the bank's videos, axis 1, and of each video
    against the bank's texts, axis 0) are recorded by axis as its loss
    computes them."""
    from neighborretr_tpu_torch.models import neighborretr as M
    seen = {}
    if not enabled:
        yield seen
        return
    orig = M.bank_centrality

    def bank_centrality(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen[kwargs.get("axis", args[5] if len(args) > 5 else 1)] = \
            out.detach().clone()
        return out

    M.bank_centrality = bank_centrality
    try:
        yield seen
    finally:
        M.bank_centrality = orig


def step_sizes(rcfg: dict, t: dict) -> dict:
    m = rcfg["model"]
    return dict(m, batch=t["batch"], bank=t["batch"] * t["mb_batch"])


def run(files: dict, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: Optional[float] = None, fault: Optional[str] = None,
        log=core.log) -> dict:
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    t = files["traffic"]
    cfg = port.program_config(files)
    rcfg = port.reference_cfg(files)
    m = cfg.model
    B, P, n_check = t["batch"], t["pool"], t["check_steps"]
    t_total = t["optim"]["t_total"]
    b1 = cfg.optim.b1

    model = port.build_model(cfg, seed, device)
    shapes = port.shapes(model)
    pool = core.generator(files).make_pool(t, m.clip.image_resolution,
                                           seed, device)
    bank = MB.create(B * t["mb_batch"], m.max_words, m.max_frames, m.width,
                     device=device)
    for i in range(t["mb_batch"]):
        bank = TS.fill_bank_step(model, bank, pool[i % P], cfg, i * B)
    state = TS.create_train_state(model, bank)
    gen = torch.Generator(device=device).manual_seed(core.derive(seed,
                                                                 "noise"))
    step = _faulty(TS.train_step, fault)
    bank0 = {k: getattr(state.bank, k).cpu()
             for k in ("feat_t", "feat_v", "mask_t", "mask_v")}
    losses = []
    for i in range(n_check):
        with centralities_recorded(i == 0) as cents:
            state, met = step(state, pool[i], cfg, t_total, gen)
        losses.append(met["loss"])
        if i == 0:
            live = [n for n, _ in shapes if n not in RT.FROZEN]
            g = torch._foreach_norm([state.opt.m[n] for n in live])
            grad = {n: float(x) / (1.0 - b1) for n, x in zip(live, g)}
            # the step's features as it wrote them to the bank's head, its
            # bank before the step and the centralities its loss took: the
            # similarity stage, followed from the program's own features
            stage = {"bank": bank0,
                     "feat": (state.bank.feat_t[:B].cpu(),
                              state.bank.feat_v[:B].cpu()),
                     "centrality": {a: c.cpu() for a, c in cents.items()}}
    start = port.reference_weights(shapes, seed, device)
    params = dict(model.named_parameters())
    d = torch._foreach_norm(torch._foreach_sub(
        [params[n].detach() for n in live], [start[n] for n in live]))
    prog = {"loss": [float(x) for x in losses], "grad": grad,
            "change": {n: float(x) for n, x in zip(live, d)},
            "bank": (state.bank.feat_t.cpu(), state.bank.feat_v.cpu()),
            "centrality": stage.pop("centrality")}
    del start, d, params, bank0
    sync(device)
    setup_s = time.time() - t_start if t_start is not None else 0.0
    log(f"set-up {setup_s:.1f} s; window of {seconds} s")

    window_losses = []
    with trace.profiled(traced) as prof:
        with trace.window_span():
            t0 = time.perf_counter()
            steps = 0
            while time.perf_counter() - t0 < seconds:
                state, met = step(state, pool[(n_check + steps) % P], cfg,
                                  t_total, gen)
                window_losses.append(torch.stack([met[k] for k in
                                                  LOSS_TERMS]))
                steps += 1
            sync(device)
            t1 = time.perf_counter()
    failed = int((~torch.isfinite(torch.stack(window_losses))).any(dim=1)
                 .sum()) if steps else 0
    dev_info = core.device_info(1) if torch.device(device).type == "cuda" \
        else {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    log(f"{steps} steps in {t1 - t0:.3f} s")

    del state, model, bank, pool, met, window_losses, gen
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(files, rcfg, shapes, seed, device, "float32",
                             stage)
    numbers = compare.train_numbers(prog, ref)
    limits = files["limits"]
    checks = {k: core.check(numbers[k], limits[k]) for k in limits}
    info = {k: v for k, v in numbers.items() if k not in limits}
    log("readings: " + ", ".join(f"{k} {v}" for k, v in numbers.items()))

    window_s = t1 - t0
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": steps, "failed": failed, "device": dev_info,
           "checks": checks, "info": info, "steps": steps,
           "window_s": window_s, "setup_s": setup_s,
           "pairs_per_s": steps * B / window_s if window_s > 0 else 0.0}
    if traced:
        r = trace.reduce(prof.events)
        out["ctx"] = {"trace": r, "kernels": readers.kernel_entries(),
                      "units": steps, "window_s": window_s,
                      "step_flops": step_flops(step_sizes(rcfg, t))}
        out["reduced"] = r
    return out


def end_to_end(out: dict) -> dict:
    return {"train_pairs_per_s": out["pairs_per_s"], "setup_s": out["setup_s"]}


def reference_readings(files: dict, rcfg: dict, shapes, seed: int, device,
                       precision: str, stage: Optional[dict] = None) -> dict:
    """The reference's loss per check step, first clipped gradient and
    change by leaf, from the cell's inputs made again from the seed; with
    `stage` (the program's first-step features and bank before it) also
    the first step's bank centralities in float64 from those."""
    set_float32_exact()
    t = files["traffic"]
    res = files["config"]["clip"]["image_resolution"]
    pool = core.generator(files).make_pool(t, res, seed, device)
    params = port.reference_weights(shapes, seed, device)
    gen = torch.Generator(device=device).manual_seed(core.derive(seed,
                                                                 "noise"))
    recs = RT.run_steps(params, pool, pool[:t["check_steps"]], rcfg,
                        Precision(precision), files["config"]["reference_chunk"],
                        gen)
    tr = recs[-1]["trainer"]
    live = list(tr.m)
    grad = {n: float(recs[0]["grads"][n].norm()) for n in live}
    change = {n: float((tr.P[n].detach() - params[n]).norm()) for n in live}
    out = {"loss": [r["terms"]["loss"] for r in recs], "grad": grad,
           "change": change,
           "bank": (tr.bank["feat_t"].cpu(), tr.bank["feat_v"].cpu())}
    if stage is not None:
        b0 = pool[0]
        cent_t, cent_v = RT.centrality_stage(
            params, *(x.to(device) for x in stage["feat"]),
            b0["text_mask"].float(), b0["video_mask"].float(),
            {k: x.to(device) for k, x in stage["bank"].items()})
        out["centrality"] = {1: cent_t.cpu(), 0: cent_v.cpu()}
    return out
