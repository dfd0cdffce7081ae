"""The port's learning check on the CPU (↔ tests/test_convergence.py's
memorisation case): from random init, tiny towers memorise 16 pairs in
120 steps through the port's `run_training`, bank fill and steps through
the prefetch, with the device placements (the host ones need a card:
chip_smoke.py's phase 20 runs this same check with both on).  Slow: ~25 s
on a CPU box."""

import pytest

from neighborretr_tpu_torch.tools import learning_check


@pytest.mark.slow
def test_port_memorises_sixteen_pairs_from_random_init():
    got = learning_check.run(device="cpu")
    assert got["steps"] == learning_check.STEPS
    # chance R@1 on 16 candidates is 6.25
    assert got["t2v_r1"] >= learning_check.R1_BAR, got
    assert got["v2t_r1"] >= learning_check.R1_BAR, got
