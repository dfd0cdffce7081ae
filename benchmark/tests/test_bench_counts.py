"""The frozen counts against the program's own at both configurations, and
the kernel bounds against the program's kernel table."""

import dataclasses

import pytest

from benchmark.counts import flops, kernels, peaks
from benchmark.harness import core, port

MAN = core.manifest()
TRAIN_CELLS = [w["name"] for w in MAN["workloads"]
               if core.cell_files(MAN, w["name"])["traffic"]["driver"]
               == "train"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("batch,bank", [(None, None), (96, 384)])
def test_step_flops_match_the_programs(cell, batch, bank):
    from neighborretr_tpu_torch.utils.flops import analytic_step_flops
    files = core.cell_files(MAN, cell)
    cfg = port.program_config(files)
    t = files["traffic"]
    B = batch or t["batch"]
    mb = (bank // B) if bank else t["mb_batch"]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=B, mb_batch=mb))
    sizes = dict(port.reference_cfg(files)["model"], batch=B, bank=B * mb)
    assert flops.step_flops(sizes) == analytic_step_flops(cfg)


def test_flagship_figure():
    files = core.cell_files(MAN, "vitb32.msrvtt_train")
    sizes = dict(port.reference_cfg(files)["model"], batch=96, bank=384)
    assert flops.step_flops(sizes) / 1e12 == pytest.approx(30.64, abs=0.01)


@pytest.mark.parametrize("family,ints,flags,ms", [
    ("K1", dict(N=1536, L=50, D=768, H=12), dict(has_bias=False), 0.3783),
    ("K1", dict(N=768, L=50, D=768, H=12), dict(has_bias=False), 0.1892),
    ("K8", dict(N=192, L=197, D=768, H=12), dict(has_bias=False), 0.0699),
    ("K2", dict(A=64, B=10000, T=24, V=12, D=512),
     dict(saved=False, bf16=False), 1.1446),
])
def test_bounds_match_the_kernel_table(family, ints, flags, ms):
    assert kernels.bound_s(family, ints, flags) * 1e3 == pytest.approx(
        ms, rel=2e-3)


def test_backward_counts_leave_recompute_out():
    f1, _, _ = kernels.k1(1536, 50, 768, 12)
    f3, _, _ = kernels.k3(1536, 50, 768, 12)
    assert f3 == 2 * f1
    f8, _, _ = kernels.k8(192, 197, 768, 12)
    f9, _, _ = kernels.k9(192, 197, 768, 12)
    assert f9 == 2 * f8


def test_k2_float32_runs_three_tf32_products():
    flop, _, peak = kernels.k2(8, 100, 24, 12, 512)
    assert flop == 3 * 2 * 8 * 24 * 100 * 12 * 512 and peak == peaks.TF32
    flop, _, peak = kernels.k2(8, 100, 24, 12, 512, bf16=True)
    assert flop == 2 * 8 * 24 * 100 * 12 * 512 and peak == peaks.BF16


def test_entry_table_names_known_families():
    from benchmark.harness import readers
    for key, e in readers.kernel_entries().items():
        assert ":" in key and e["family"].startswith("K")
        if e["family"] in kernels.FAMILIES:
            assert e["ints"]
