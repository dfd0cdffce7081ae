"""Named spans of the program's phases, on a profile's own clock.

`span(name)` is a `torch.profiler.record_function` while a `torch.profiler`
session records (the train loop's `--profile_dir` window, a benchmark's
traced run), and one shared null context otherwise, so an unprofiled step
pays a flag read a span.  A span is a user-scope event of the profile: it
lands beside the CUDA runtime's calls and the card's kernels, on their
clock.  Every name starts with `nr::`; spans open per step or per device
call, never per request or query.

    nr::step              train/step.py::train_step, the whole step
      nr::step.towers       the towers' forward (GradCache's first pass)
      nr::step.losses       similarity, CTM, global level, the four losses
      nr::step.backward     the backward, GradCache's second pass, the
                            gradients' all-reduce
      nr::step.update       BertAdam, the logit clamp, the FIFO bank write
    nr::token_weights     the two token-weight MLPs of a similarity
    nr::search            serving.py::Searcher.search, one device call
      nr::search.tokenise   the queries' tokens (host only)
      nr::search.text       the text tower
      nr::search.similarity corpus token weights, normalisation, K2
      nr::search.topk       the top-k and the [Q, k] copy out
    nr::dispatch.wait     the dispatcher blocked on an empty queue
    nr::dispatch.merge    from the first request in hand to the call
    nr::loader.wait       train/loop.py, the host blocked on the loader

Under GradCache (`train.micro_batches > 1`) the towers' and the losses'
spans nest inside the backward's, which also holds the second pass; on
the explicit SPMD form the towers' nests inside the losses'.  A reader
counts the innermost phase open.

The gate reads torch's process-wide flag: a profile started with
`profile_all_threads` records every thread while the thread-local
`torch.autograd._profiler_enabled()` reads false on each.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a `torch.profiler` session is recording."""
    return (getattr(_profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


def span(name: str):
    """A `record_function(name)` while a profile records, else the shared
    null context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF
