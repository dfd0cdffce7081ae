"""The check catches a broken timed path.  Each cell's run is driven on the
CPU at a tiny size (the look for a card skipped), once sound and once with
each fault the cell can have planted under it; `correct` has to come out
true and then false, under the cell's own limits.  Faults: a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; an answer altered where it is produced.  (The exchange
between chips has no place in a one-card cell.)"""

import time

import pytest

from benchmark.kinds import search, train
from benchmark.tests.tiny import tiny_files

CASES = [("vitb32.msrvtt_train", None), ("vitb32.msrvtt_train", "unchanged"),
         ("vitb32.msrvtt_train", "half_batch"),
         ("vitb16.msrvtt_train", "unchanged"),
         ("vitb32.search", None), ("vitb32.search", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_check_sees_the_fault(cell, fault):
    files = tiny_files(cell)
    driver = train if files["traffic"]["driver"] == "train" else search
    out = driver.run(files, 2 ** 31 + 41, 0.3, False, "cpu", time.time(),
                     fault, log=lambda m: None)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
