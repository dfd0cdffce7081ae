"""How often `torch.profiler` loses the kernel events of a short profiled
call, and when, against the launches counted where they are made.

    python3 -m neighborretr_tpu_torch.tools.profiler_probe [--sessions 300] \
        [--out FILE.json]

The call is K5's one-side backward (ops/similarity.py::fused_similarity_bwd
with need_v=False) at the train step's (128, 24, 1920, 12, 512) on exact
inputs, which launches one routed_gather_kernel (the library's own count,
`similarity.gather_launches`, says how many).  Each session profiles one
call under `profile(activities=[CUDA])` and counts the gather kernels in
`key_averages()`, in these forms:

  tight     as tests/test_torch_gpu.py's launch-count test did: enter,
            call, synchronize, leave;
  margin    the same with 2 ms of host time after entering and before
            leaving (the call's kernels well inside the capture window);
  after_big each `tight` session follows a profile of 20,000 small
            launches (the chip_smoke.py --profile pattern that lost events
            before);
  cpu_too   `tight` with CPU activity profiled as well.

Per form it prints how many sessions counted other than the library's count
and, of those, how many saw no kernel event at all.
"""

from __future__ import annotations

import argparse
import json
import time

FORMS = ("tight", "margin", "after_big", "cpu_too")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import similarity as S

    dev = torch.device("cuda")
    A, B, T, V, D = 128, 1920, 24, 12, 512
    rng = np.random.default_rng(0)
    tm = np.arange(T)[None] < rng.integers(1, T + 1, A)[:, None]
    vm = np.arange(V)[None] < rng.integers(1, V + 1, B)[:, None]
    arrays = (rng.integers(-4, 5, (A, T, D)) / 8.0 * tm[..., None],
              rng.integers(-4, 5, (B, V, D)) / 8.0 * vm[..., None],
              rng.dirichlet(np.ones(T), size=A),
              rng.dirichlet(np.ones(V), size=B), rng.standard_normal((A, B)))
    tn, vn, tw, vw, g = [torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev) for a in arrays]
    _, res = S._similarity_fwd(tn, vn, tw, vw, save=True)

    def call():
        S.fused_similarity_bwd(tn, vn, tw, vw, g, *res, need_v=False)

    call()
    torch.cuda.synchronize()
    small = torch.zeros(1, device=dev)

    def session(form):
        if form == "after_big":
            with profile(activities=[ProfilerActivity.CUDA]):
                for _ in range(20_000):
                    small.add_(1)
                torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if form == "cpu_too" else [])
        before = S.gather_launches()
        with profile(activities=acts) as trace:
            if form == "margin":
                time.sleep(0.002)
            call()
            torch.cuda.synchronize()
            if form == "margin":
                time.sleep(0.002)
        launched = S.gather_launches() - before
        events = trace.key_averages()
        seen = sum(e.count for e in events if "routed_gather_kernel" in e.key)
        kernels = sum(e.count for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        return launched, seen, kernels

    report = {}
    for form in FORMS:
        n = args.sessions // 10 if form == "after_big" else args.sessions
        rows = [session(form) for _ in range(n)]
        wrong = [r for r in rows if r[1] != r[0]]
        report[form] = {"sessions": n, "launched": sum(r[0] for r in rows),
                        "miscounted": len(wrong),
                        "no_kernel_event": sum(r[2] == 0 for r in wrong),
                        "first_wrong": wrong[:5]}
        print(f"{form}: {n} sessions, {len(wrong)} counted other than the "
              f"library ({report[form]['no_kernel_event']} of them with no "
              f"kernel event at all); first: {wrong[:5]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
