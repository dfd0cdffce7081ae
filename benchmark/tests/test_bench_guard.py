"""Nothing a run loads is JAX or the JAX package, compared by whole top-level
names; the reference loads nothing of the program."""

import subprocess
import sys

from benchmark.harness import core

ROOT = core.ROOT


def test_top_level_names_compared_whole():
    mods = ["neighborretr_tpu_torch", "neighborretr_tpu_torch.ops._build",
            "jaxtyping", "benchmark.kinds.train"]
    assert core.forbidden_loaded(mods) == []
    bad = ["neighborretr_tpu", "neighborretr_tpu.models", "jax.numpy",
           "jaxlib", "flax.linen"]
    assert core.forbidden_loaded(mods + bad) == sorted(bad)
    assert core.program_loaded(mods) == mods[:2]


def _run(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU (set-up, window, reference, metrics) in a
    fresh interpreter, then the modules it loaded."""
    out = _run(
        "import sys, time\n"
        "from benchmark.harness import cli, core, readers\n"
        "from benchmark.kinds import train\n"
        "from benchmark.tests.tiny import tiny_files\n"
        "f = tiny_files('vitb32.msrvtt_train')\n"
        "train.run(f, 5, 0.2, False, 'cpu', time.time(), log=lambda m: 0)\n"
        "print(core.forbidden_loaded(), bool(core.program_loaded()))\n")
    assert out == "[] True"


def test_the_reference_loads_nothing_of_the_program():
    out = _run(
        "import benchmark.reference.model, benchmark.reference.train\n"
        "import benchmark.reference.search, benchmark.reference.tokenizer\n"
        "import benchmark.counts.flops, benchmark.counts.kernels\n"
        "from benchmark.harness import core\n"
        "print(core.forbidden_loaded(), core.program_loaded())\n")
    assert out == "[] []"


def test_the_reference_vocabulary_is_pinned(tmp_path):
    """The reference reads CLIP's merges from the repo's frozen copy by
    path and refuses any other file."""
    import gzip
    import pytest
    from benchmark.reference import tokenizer
    assert tokenizer.Tokenizer().caption("a man", 8)[0][0] == 49406
    other = tmp_path / "bpe.txt.gz"
    other.write_bytes(gzip.compress(b"#version\na b\n"))
    with pytest.raises(ValueError, match="SHA-256"):
        tokenizer.Tokenizer(str(other))
