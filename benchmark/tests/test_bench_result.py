"""The result line's keys, the checks printed last, and a run that finds no
card: it fails and prints no result, also from a checkout that holds only
the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cli, core

ROOT = core.ROOT


def _emit(capsys, breakdown=None):
    checks = {"loss_gap": core.check(0.01, 0.02),
              "grad_gap": core.check(0.5, 0.2)}
    core.emit(False, 10, 1, {"x": {"value": 1.5, "unit": "s"}},
              {"platform": "gpu", "kind": "k", "count": 1,
               "memory_peak_bytes": 5}, checks, breakdown)
    return capsys.readouterr()


def test_last_line_keys_and_checks_last(capsys):
    cap = _emit(capsys)
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["checks"]["grad_gap"] == {"value": 0.5, "limit": 0.2}
    err = cap.err.strip().splitlines()
    assert err[-2].startswith("check loss_gap: 0.01 (limit 0.02) ok")
    assert err[-1].endswith("FAILED")


def test_traced_line_has_breakdown_before_checks(capsys):
    cap = _emit(capsys, {"device_ops": [["a", 0.1]], "idle_gaps": []})
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert list(out)[-2:] == ["breakdown", "checks"]


def test_check_fails_non_finite():
    assert not core.check(float("nan"), 1.0)["ok"]
    assert not core.check(float("inf"), 1.0)["ok"]
    assert core.check(1.0, 1.0)["ok"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "vitb32.msrvtt_train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out.strip() == ""
    assert "no card" in cap.err


def test_too_few_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(core.BenchError):
        core.require_cards(1)


def test_benchmark_alone_fails_without_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ runs nothing."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "vitb32.msrvtt_train", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
