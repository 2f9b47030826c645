"""The port's bench (``python -m lstm_ctc_tpu_torch.bench``) and
per-segment profiler (``python -m lstm_ctc_tpu_torch.scripts.profile_step``)
on the CPU at tiny shapes: the bench's FLOP formula is ``bench.py``'s, its
JSON line has ``bench.py``'s keys and rows, a failed row or a missing card
ends it non-zero, and the profiler prints every segment and
decomposition key.  Their numbers here mean nothing; the card's are in
PERF.md."""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench as ref_bench
from lstm_ctc_tpu_torch import bench
from lstm_ctc_tpu_torch.graft_entry import FLAGSHIP_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one intra-op thread a run: the suite runs test files side by side
ENV = dict(os.environ, OMP_NUM_THREADS="1")
ROWS = ["flagship_b32_t384", "flagship_b64_t384", "recipe_packed_pf3_b32",
        "lstm_b32_t384", "cudnnlstm_b32_t384", "lstm_bn_b32_t384",
        "streaming_lstm_b1_chunk4"]
KEYS = {"metric", "value", "unit", "mfu", "vs_baseline", "baseline_note",
        "configs", "model_train_mflops_per_frame", "mfu_peak_note",
        "forward_frames_per_sec", "device"}


@pytest.mark.parametrize("overrides", [
    {},                                                   # flagship
    {"num_experts": 0},                                   # dense head
    {"nnet_type": "lstm", "num_experts": 0},              # lstm
    {"nnet_type": "cudnnlstm", "num_projects": None,
     "use_peepholes": False, "num_experts": 0},           # cudnnlstm
    {"nnet_type": "lstm", "num_experts": 0, "use_bn": True},  # lstm_bn
    {"num_layers": 2, "num_neurons": 16, "num_projects": 16,
     "num_experts": 4},                                   # the smoke widths
])
def test_flop_formula_is_bench_py_s(overrides):
    config = dict(FLAGSHIP_CONFIG, **overrides)
    assert bench.model_fwd_flops_per_frame(config) == \
        ref_bench.model_fwd_flops_per_frame(config)


def run(module, args, timeout=600):
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, cwd=REPO, env=ENV,
                          timeout=timeout)


def test_bench_smoke_on_the_cpu():
    r = run("lstm_ctc_tpu_torch.bench", ["--smoke", "--device", "cpu"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    result = lines[-1]
    assert set(result) == KEYS
    assert result["metric"] == "train_frames_per_sec_per_chip"
    assert [row["config"] for row in result["configs"]] == ROWS
    assert not any("error" in row or "skipped" in row
                   for row in result["configs"])
    assert result["value"] > 0 and result["forward_frames_per_sec"] > 0
    assert result["value"] == result["configs"][0]["frames_per_sec"]
    assert "989 TFLOP/s" in result["mfu_peak_note"]
    assert result["device"] == "cpu"
    packed = result["configs"][2]
    assert 0 < packed["fill"] <= 1 and packed["frames_per_sec"] > 0
    streaming = result["configs"][-1]
    assert streaming["ms_per_chunk"] > 0 and streaming["real_time_factor"] > 0
    # the line is re-printed after every row
    assert len(lines) == len(ROWS) + 1


def test_bench_fails_on_a_failed_row(monkeypatch, capsys):
    def broken(self, *args, **kwargs):
        raise RuntimeError("row failed")

    # the unpacked rows "run" at a fixed rate, the packed row fails
    monkeypatch.setattr(bench.Bench, "unpacked", lambda *a: 1000.0)
    monkeypatch.setattr(bench.Bench, "packed", broken)
    with pytest.raises(RuntimeError, match="row failed"):
        bench.main(["--smoke", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # what finished is printed: the two unpacked rows, not the failed one
    assert [row["config"] for row in last["configs"]] == ROWS[:2]


def test_bench_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run("lstm_ctc_tpu_torch.bench", ["--smoke"])
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_profile_step_on_the_cpu():
    r = run("lstm_ctc_tpu_torch.scripts.profile_step",
            ["--tiny", "--device", "cpu", "--batch", "4", "--time-steps",
             "32", "--steps", "2"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    segments = ["fwd_chain", "fwd_logits", "ctc_fwd", "ctc_fwdbwd",
                "fwd_loss", "grad", "full_step"]
    assert list(report["segments_ms"]) == segments
    assert all(v > 0 for v in report["segments_ms"].values())
    assert set(report["decomposition_ms"]) == {
        "blstm_chain_fwd", "moe_head_fwd", "ctc_fwd", "ctc_bwd",
        "backward_minus_forward", "optimizer_and_update"}
    assert report["batch"] == 4 and report["time_steps"] == 32
    assert report["train_frames_per_sec"] > 0
    # no device profile on the CPU
    assert report["full_step_device_ms_by_kernel"] is None
    for name in segments:
        assert any(line.startswith(name) for line in
                   r.stdout.splitlines()), name
