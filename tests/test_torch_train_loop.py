"""The port's in-process training loop (``bin/nnet_train_loop``) against
the JAX package's ``bin/nnet-train-loop.py``, on a tiny MoE-head corpus on
the CPU.

Both start from the same JAX-initialized ``nnet.0`` and ``nnet.0.done``
and train three iterations at keep 1.0 (float32 on both sides): the same
accept / reject / halving lines, ``.done`` values within 1e-4 relative and
checkpoints within rtol = atol = 1e-4 (adam moves each weight by about the
learning rate whatever the gradient's size, so rounding differences of the
two packages show in full, as in ``test_torch_train.py``).  The port then
resumes from its ``.done`` markers.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.bin import nnet_train_loop
from lstm_ctc_tpu_torch.host.config import format_config
from lstm_ctc_tpu_torch.host.data import RecordShardWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 5
INPUT_DIM = 8
CONFIG = dict(nnet_type="blstm", input_dim=INPUT_DIM, left_context=0,
              right_context=0, subsample=0, num_layers=1, num_neurons=16,
              num_projects=8, num_targets=NUM_CLASSES, use_peepholes=True,
              dropout_rate=1.0, num_experts=3, moe_temp=10.0, seed=3,
              store_dtype="float32")
# lines of the schedule's decisions, compared line for line
DECISIONS = ("training with learn_rate", "nnet_in", "nnet accepted",
             "nnet rejected", "halving", "halved", "finished, too small",
             "min_iters")


def write_corpus(work):
    """24 labeled utterances: each label a few frames around its class
    mean, so that training lowers the CV loss."""
    rng = np.random.RandomState(3)
    means = np.random.RandomState(11).randn(NUM_CLASSES - 1, INPUT_DIM) * 2.0
    scp = os.path.join(work, "feats.scp")
    with RecordShardWriter(os.path.join(work, "feats.rec")) as writer:
        for i in range(24):
            labels = rng.randint(0, NUM_CLASSES - 1, rng.randint(2, 5))
            frames = [means[lab] + 0.3 * rng.randn(rng.randint(2, 4),
                                                   INPUT_DIM)
                      for lab in labels]
            writer.write("utt%03d" % i, np.concatenate(frames).astype(
                np.float32), labels.astype(np.int32))
        with open(scp, "w") as fh:
            fh.write("".join(m.scp_line() for m in writer.metas))
    return scp


def common_args(work, scp):
    config = os.path.join(work, "nnet.config")
    with open(config, "w") as fh:
        fh.write(format_config(CONFIG))
    return ["--tr-tfrecords-scp", scp, "--cv-tfrecords-scp", scp,
            "--nnet-config", config, "--objective", "ctc",
            "--optimizer", "adam", "--learn-rate", "0.05",
            "--max-iter", "3", "--min-iters", "0", "--batch-size", "8",
            "--cv-goal", "loss", "--shuffle", "true", "--pack-factor", "2",
            "--start-halving-impr", "0.05", "--report-interval", "0"]


def run_jax_loop(outdir, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "nnet-train-loop.py"),
         "--dir", outdir] + args,
        capture_output=True, text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, "stdout:\n%s\nstderr:\n%s" % (
        proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def decisions(stdout):
    """(the decision lines with their numbers taken out, the numbers)."""
    lines = [ln for ln in stdout.splitlines()
             if any(d in ln for d in DECISIONS)]
    return ([NUMBER.sub("#", ln) for ln in lines],
            [float(v) for ln in lines for v in NUMBER.findall(ln)])


def read_done(path):
    with open(path) as fh:
        return {k: float(v) for k, v in (ln.split() for ln in fh)}


def test_loop_matches_jax_nnet_train_loop(tmp_path, capsys):
    work = str(tmp_path)
    scp = write_corpus(work)
    args = common_args(work, scp)
    exp_jax, exp_port = (os.path.join(work, d) for d in ("jax", "port"))
    ref_out = run_jax_loop(exp_jax, args)

    os.makedirs(exp_port)
    for name in ("nnet.0", "nnet.0.done"):
        shutil.copy(os.path.join(exp_jax, name), os.path.join(exp_port, name))
    nnet_train_loop.main(["--dir", exp_port, "--device", "cpu"] + args)
    out = capsys.readouterr().out

    (text, numbers), (ref_text, ref_numbers) = decisions(out), decisions(
        ref_out)
    assert text == ref_text
    # learning rates exactly; relative improvements as the CV losses agree
    np.testing.assert_allclose(numbers, ref_numbers, rtol=1e-3, atol=1e-4)
    assert "nnet rejected (nnet.3)" in out and "halved learning rate" in out
    for it in range(4):
        a, b = (os.path.join(d, "nnet.%d" % it) for d in (exp_jax, exp_port))
        with np.load(a) as ref, np.load(b) as got:
            assert sorted(ref.files) == sorted(got.files)
            for k in ref.files:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                           atol=1e-4, err_msg="%d %s" % (it, k))
        ref_done, got_done = read_done(a + ".done"), read_done(b + ".done")
        assert sorted(ref_done) == sorted(got_done)
        for key, value in ref_done.items():
            assert abs(got_done[key] - value) <= 1e-4 * abs(value) + 1e-6, \
                (it, key, got_done, ref_done)
        if it > 0:
            assert os.path.exists(os.path.join(exp_port,
                                               "nnet.%d.metrics.jsonl" % it))
    with open(os.path.join(exp_jax, "final.nnet")) as fa, \
            open(os.path.join(exp_port, "final.nnet")) as fb:
        assert fa.read() == fb.read()

    # the port resumes off its .done markers
    nnet_train_loop.main(["--dir", exp_port, "--device", "cpu"] + args)
    assert capsys.readouterr().out.count("skipping this iteration") == 3


def test_a_rejected_epoch_leaves_the_best_model_as_it_was(tmp_path, capsys):
    """The train step updates the weights in place: after a rejected
    epoch the next one must start from the best checkpoint's weights.
    Without shuffling or dropout the seed does not matter, so the epoch
    after a rejection equals a first epoch at the halved rate."""
    work = str(tmp_path)
    args = common_args(work, write_corpus(work))
    args[args.index("--shuffle") + 1] = "false"
    rejecting, direct = (os.path.join(work, d) for d in ("a", "b"))
    nnet_train_loop.main(["--dir", rejecting, "--device", "cpu"] + args
                         + ["--learn-rate", "0.4", "--max-iter", "2"])
    out = capsys.readouterr().out
    assert "nnet rejected (nnet.1)" in out and "nnet_in = nnet.0" in out
    os.makedirs(direct)
    for name in ("nnet.0", "nnet.0.done"):
        shutil.copy(os.path.join(rejecting, name), os.path.join(direct, name))
    nnet_train_loop.main(["--dir", direct, "--device", "cpu"] + args
                         + ["--learn-rate", "0.2", "--max-iter", "1"])
    with np.load(os.path.join(rejecting, "nnet.2")) as a, \
            np.load(os.path.join(direct, "nnet.1")) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loop_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnet_train_loop.main(["--tr-tfrecords-scp", "x.scp",
                              "--cv-tfrecords-scp", "x.scp",
                              "--nnet-config", "nnet.config",
                              "--dir", str(tmp_path), "--objective", "ctc"])
