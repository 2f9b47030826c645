"""Hold data-parallel training on every visible card against one card.

    python -m lstm_ctc_tpu_torch.scripts.dp_check [--utterances 64]
        [--device cuda | --device cpu --ranks N] [--work DIR]

On a host with several cards (``--device cuda``, the default):

  1. a synthetic labeled corpus on the flagship front end (600-1200 raw
     40-dim frames an utterance, raw/8 labels of 71 classes; 64 make two
     batches), the flagship MoE model in float32 at keep 1.0,
     ``nnet_init`` on card 0;
  2. ``nnet_train`` (adam 1e-3, batch 32, pack factor 3) on card 0 alone
     (``CUDA_VISIBLE_DEVICES=0``), again from the weights moved one unit in
     the last place (the yardstick), and on every card, where the tool
     itself starts one NCCL rank a card (``cli.spawn_over_cards``);
  3. ``nnet_validate`` of the every-card model, on card 0 and on every card;
  4. the bench under the standard launcher on every card (its
     ``mesh_dp<n>`` row: the data-parallel step at 32 rows a card).

Prints one JSON line: the cards, each leg's seconds, the ``tr_loss`` and
``cv_loss`` values, the gaps of the every-card and the moved-weights
trainings' parameter updates from card 0's (||Δ − Δ_1|| / ||Δ_1|| over
the leaves), and the bench's line.  Exits non-zero when a tool fails,
when ``cv_loss`` of one model differs between one card and every card by
more than 1e-5 relative, or when the every-card training differs from
card 0's by more than float32's train-step bounds in ``chip_smoke.py``:
``tr_loss`` by more than 1e-4 relative or 10x what moving every weight one
unit in the last place gives (the larger), the update by more than 10x
what that move gives.  That yardstick is large for the float32 flagship
at random weights (an update gap of ~0.5 after two steps, ~1 after nine,
on H100s): adam moves each weight by about the learning rate whatever
its gradient's size, so a last-bit change of a near-zero gradient flips
its step.  The default corpus makes two steps.  With ``--device cpu --ranks N`` the
every-card legs run N gloo ranks under the launcher on the CPU (tiny
widths: a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"num_layers": 2, "num_neurons": 16, "num_projects": 16,
        "num_experts": 4}


def write_corpus(work, count, rng):
    from lstm_ctc_tpu_torch.host.data import RecordShardWriter
    scp = os.path.join(work, "train.scp")
    with RecordShardWriter(os.path.join(work, "train.rec")) as writer:
        for i in range(count):
            frames = int(rng.randint(600, 1201))
            writer.write("spk%03d" % i, rng.randn(frames, 40).astype(
                np.float32), rng.randint(0, 71, frames // 8).astype(np.int32))
        with open(scp, "w") as fh:
            fh.write("".join(m.scp_line() for m in writer.metas))
    return scp


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run(args, env=None, launcher_ranks=0):
    """``python -m args`` (under the launcher with ``launcher_ranks``);
    (stdout, stderr, seconds); a failure ends the check."""
    cmd = [sys.executable, "-m"]
    if launcher_ranks:
        cmd += ["torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
                str(launcher_ranks), "--master_port", str(free_port()), "-m"]
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    start = time.perf_counter()
    proc = subprocess.run(cmd + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=1800)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        sys.exit("dp_check: %s exit %d:\n%s\n%s" % (
            " ".join(args[:1]), proc.returncode, proc.stdout[-2000:],
            proc.stderr[-3000:]))
    return proc.stdout, proc.stderr, seconds


def logged(stderr, name):
    hits = re.findall(r"^INFO:[^:]*:%s = (\S+)$" % name, stderr, re.M)
    if len(hits) != 1:
        sys.exit("dp_check: %d %s lines, not one:\n%s"
                 % (len(hits), name, stderr[-2000:]))
    return float(hits[0])


def moved(src, dst, rng):
    """``src``'s checkpoint with every float32 weight moved one unit in the
    last place, up or down at random, written to ``dst``."""
    arrays = dict(np.load(src))
    for key, value in arrays.items():
        if key.startswith("params/") and value.dtype == np.float32:
            away = np.where(rng.rand(*value.shape) < 0.5, np.inf, -np.inf)
            arrays[key] = np.nextafter(value, away.astype(np.float32))
    with open(dst, "wb") as fh:
        np.savez(fh, **arrays)


def update_gap(start_one, one, start, other):
    """||Δ_other − Δ_one|| / ||Δ_one|| over the weights, each Δ the change
    of a training from its own start."""
    num = den = 0.0
    for key in one.files:
        if key.startswith("params/"):
            d_one = one[key] - start_one[key]
            num += float(((other[key] - start[key] - d_one) ** 2).sum())
            den += float((d_one ** 2).sum())
    return math.sqrt(num / den)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utterances", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --device cpu: gloo ranks under the launcher")
    ap.add_argument("--work", default=None)
    args = ap.parse_args(argv)

    import torch
    from lstm_ctc_tpu_torch.graft_entry import FLAGSHIP_CONFIG
    from lstm_ctc_tpu_torch.host.config import format_config
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            sys.exit("dp_check: needs two or more cards (--device cpu "
                     "--ranks N rehearses on the CPU)")
        ranks, one_card = torch.cuda.device_count(), {
            "CUDA_VISIBLE_DEVICES": "0"}
        launched = 0   # the tools start one process a card themselves
    else:
        if args.ranks < 2:
            sys.exit("dp_check: --device cpu needs --ranks N >= 2")
        ranks, one_card, launched = args.ranks, {}, args.ranks
    work = args.work or tempfile.mkdtemp(prefix="dp_check")
    os.makedirs(work, exist_ok=True)
    scp = write_corpus(work, args.utterances, np.random.RandomState(0))
    config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0, compute_dtype="float32",
                  store_dtype="float32")
    if args.device == "cpu":
        config.update(TINY)
    config_path = os.path.join(work, "nnet.config")
    with open(config_path, "w") as fh:
        fh.write(format_config(config))
    dev = ["--device", args.device]
    nnet0 = os.path.join(work, "nnet.0")
    run(["lstm_ctc_tpu_torch.bin.nnet_init", scp, config_path, nnet0,
         "--objective", "ctc", "--batch-size", "32"] + dev, one_card)
    nudged = os.path.join(work, "nnet.0.nudged")
    moved(nnet0, nudged, np.random.RandomState(3))
    train = ["--objective", "ctc", "--optimizer", "adam", "--learn-rate",
             "1e-3", "--batch-size", "32", "--pack-factor", "3"] + dev
    out = {"ranks": ranks, "seconds": {}}
    models = {}
    for leg, start, env, n in (("one", nnet0, one_card, 0),
                               ("nudged", nudged, one_card, 0),
                               ("every", nnet0, None, launched)):
        models[leg] = os.path.join(work, "%s.npz" % leg)
        _, err, out["seconds"]["train_" + leg] = run(
            ["lstm_ctc_tpu_torch.bin.nnet_train", scp, config_path, start,
             models[leg]] + train, env, n)
        out["tr_loss_" + leg] = logged(err, "tr_loss")
        if leg == "nudged":
            continue
        _, err, out["seconds"]["validate_" + leg] = run(
            ["lstm_ctc_tpu_torch.bin.nnet_validate", scp, config_path,
             models[leg], "--objective", "ctc", "--batch-size", "32"] + dev,
            env, n)
        out["cv_loss_" + leg] = logged(err, "cv_loss")
    # the every-card model validated on one card too: the same model,
    # so only the order of the sums differs
    _, err, _ = run(["lstm_ctc_tpu_torch.bin.nnet_validate", scp,
                     config_path, models["every"], "--objective", "ctc",
                     "--batch-size", "32"] + dev, one_card)
    out["cv_loss_every_model_one_card"] = logged(err, "cv_loss")
    one = (np.load(nnet0), np.load(models["one"]))
    out["update_gap"] = update_gap(*one, np.load(nnet0),
                                   np.load(models["every"]))
    out["update_gap_nudged"] = update_gap(*one, np.load(nudged),
                                          np.load(models["nudged"]))
    bench = ["lstm_ctc_tpu_torch.bench"] + (
        ["--smoke", "--device", "cpu", "--steps", "1"]
        if args.device == "cpu" else [])
    stdout, _, out["seconds"]["bench"] = run(bench, None, ranks)
    out["bench"] = json.loads(stdout.strip().splitlines()[-1])
    print(json.dumps(out), flush=True)
    cv_rel = abs(out["cv_loss_every"] - out["cv_loss_every_model_one_card"]) \
        / abs(out["cv_loss_every_model_one_card"])
    tr_rel, tr_nudged = (abs(out[k] - out["tr_loss_one"])
                         / abs(out["tr_loss_one"])
                         for k in ("tr_loss_every", "tr_loss_nudged"))
    mesh = [r for r in out["bench"]["configs"]
            if r["config"].startswith("mesh_dp%d_" % ranks)]
    if cv_rel > 1e-5 or tr_rel > max(1e-4, 10 * tr_nudged) \
            or out["update_gap"] > 10 * out["update_gap_nudged"] or not mesh:
        sys.exit("dp_check: every card differs from one card: cv_loss rel "
                 "%.3e, tr_loss rel %.3e (bound 1e-4 or 10 x %.3e), update "
                 "gap %.3e (bound 10 x %.3e), mesh row %s"
                 % (cv_rel, tr_rel, tr_nudged, out["update_gap"],
                    out["update_gap_nudged"], mesh))


if __name__ == "__main__":
    main()
