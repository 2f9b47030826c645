"""The port's A/B tool (``python -m lstm_ctc_tpu_torch.scripts.
ab_train_step``) on the CPU with tiny shapes: it must keep working, since
it is the instrument that times the opt-in backward modes against the
default on the card, and a harness fault would show only there."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = [sys.executable, "-m", "lstm_ctc_tpu_torch.scripts.ab_train_step"]
# one intra-op thread a run: the suite runs test files side by side, and
# the tool's subprocesses would otherwise each take every core
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run(extra_args):
    r = subprocess.run(
        TOOL + ["a=", "b=moe_wgrad_mode=kernel,lstm_fold_dx=true",
                "--tiny", "--device", "cpu", "--repeats", "1", "--steps",
                "2", "--batch", "4", "--time-steps", "32"] + extra_args,
        capture_output=True, text=True, cwd=REPO, env=ENV, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    per_run = [line for line in lines if "variant" in line]
    assert not any("error" in line for line in per_run), per_run
    return per_run, lines[-1]["summary"]


def test_ab_tool_unpacked_smoke():
    per_run, summary = _run([])
    assert [line["variant"] for line in per_run] == ["a", "b"]
    assert all(line["frames_per_sec"] > 0 for line in per_run)
    # the comparison field names the baseline variant
    assert "vs_a" in summary["b"]
    assert summary["a"]["runs"] == [per_run[0]["frames_per_sec"]]


def test_ab_tool_packed_mode():
    per_run, summary = _run(["--packed", "2"])
    assert all(line["frames_per_sec"] > 0 for line in per_run)
    # packed rows report the real-frame fill beside the throughput
    assert all(0.0 < line["fill"] <= 1.0 for line in per_run)
    assert summary["a"]["best"] > 0 and summary["b"]["best"] > 0


def test_ab_tool_rejects_malformed_config():
    for bad in (["a=", "--config", "{not json"], ["a=", "--config", "[1]"],
                ["a=key"]):
        r = subprocess.run(TOOL + bad + ["--tiny", "--device", "cpu"],
                           capture_output=True, text=True, cwd=REPO, env=ENV,
                           timeout=120)
        assert r.returncode != 0, bad
