"""A/B the flagship train step under different nnet.config settings.

Usage:
  python -m lstm_ctc_tpu_torch.scripts.ab_train_step \\
      default= fold=lstm_fold_dx=true k7=moe_wgrad_mode=kernel \\
      [--batch 32] [--time-steps 384] [--repeats 2] [--steps 100] \\
      [--tiny] [--packed PF] [--config JSON] [--timeout S] [--device cuda]

The port's counterpart of ``scripts/ab_train_step.py``.  Each positional
argument is ``name=key=val[,key=val...]``: nnet.config keys laid over the
flagship config, each value typed as nnet.config types it (empty = as
shipped); the reference's tool sets environment variables instead.  Each
variant runs in its own subprocess, so nothing one builds is reused by
another; repeats interleave A/B/A/B to decorrelate slow drifts of the card.
Prints one JSON line per (variant, repeat) with ``frames_per_sec`` (plus
``fill`` with ``--packed``), then ``{"summary": {name: {"best", "runs",
"vs_<first>"}}}``, ``vs_<first>`` the best run's change in percent against
the first variant's best.

A run trains the flagship model (random weights from its seed, keep 1.0)
with adam through ``train/graph.make_train_step``: unpacked, on one
synthetic ``[B, T]`` batch of full-length rows (frames/s counts B·T a
step); with ``--packed``, on six packed batches that ``BucketedBatcher``
makes from a WSJ-like length mix (frames/s counts the real frames).  It
warms the step, then times one window of ``--steps`` steps that ends in a
synchronisation: with CUDA events on the card, with the host clock on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from lstm_ctc_tpu_torch.graft_entry import FLAGSHIP_CONFIG

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"num_layers": 2, "num_neurons": 16, "num_projects": 16,
        "num_experts": 4}


def parse_variant(spec: str):
    """``name=key=val[,key=val...]`` → (name, {key: typed value})."""
    from lstm_ctc_tpu_torch.host.config import coerce
    name, _, rest = spec.partition("=")
    overrides = {}
    for item in filter(None, rest.split(",")):
        key, sep, value = item.partition("=")
        if not key or not sep:
            raise ValueError("variant %r: %r is not key=val" % (spec, item))
        overrides[key] = coerce(value)
    return name, overrides


def example_batch(config, batch, time_steps, rng_seed=0):
    """``graft_entry._example_batch`` as a host batch: full-length random
    rows and short random labels."""
    from lstm_ctc_tpu_torch.graft_entry import _example_batch
    from lstm_ctc_tpu_torch.host.data.pipeline import Batch
    return Batch(**_example_batch(config, batch, time_steps, rng_seed))


def packed_batches(config, batch_size, pack_factor, tiny):
    """Six packed batches from ``BucketedBatcher`` over synthetic
    utterances of 200-1152 raw frames (30-120 with ``tiny``), as
    ``bench.bench_packed`` makes them; returns (batches, real frames of
    each, mean fill)."""
    from lstm_ctc_tpu_torch.host.data import BucketedBatcher, RecordMeta
    rng = np.random.RandomState(0)
    n_utts = max(512, 8 * batch_size * pack_factor)
    lo, hi = 200, 1152
    if tiny:
        n_utts, lo, hi = 4 * batch_size * pack_factor, 30, 120
    raw_dim = config["input_dim"]
    lengths = rng.randint(lo, hi, size=n_utts)
    metas = [RecordMeta("u%03d" % i, int(t), raw_dim, True, "mem", i)
             for i, t in enumerate(lengths)]
    feats = {m.key: rng.randn(m.num_rows, raw_dim).astype(np.float32)
             for m in metas}
    labels = {m.key: rng.randint(0, config["num_targets"] - 1, max(
        2, m.num_rows // 30)).astype(np.int32) for m in metas}

    class Loader:
        def load(self, meta):
            return meta.key, feats[meta.key], labels[meta.key]

    batcher = BucketedBatcher(
        metas, batch_size=batch_size, left_context=config["left_context"],
        right_context=config["right_context"],
        subsample=config["subsample"],
        label_lengths=[len(labels[m.key]) for m in metas],
        pack_factor=pack_factor)
    batches = [batcher.assemble(bucket, rows, Loader())
               for bucket, rows in batcher.batch_plan(True, 0)[:6]]
    real = [int(b.utt_sequence_length.sum()) for b in batches]
    fill = float(np.mean([r / b.nnet_input.shape[0] / b.nnet_input.shape[1]
                          for r, b in zip(real, batches)]))
    return batches, real, fill


def run_variant(args, overrides) -> dict:
    """One variant in this process: {"frames_per_sec"[, "fill"]}."""
    import torch
    from lstm_ctc_tpu_torch.cli import (init_from_config, make_shard_fn,
                                        resolve_device)
    from lstm_ctc_tpu_torch.train.checkpoint import tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    device = resolve_device(args.device)
    config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
    if args.tiny:
        config.update(TINY)
    config.update(json.loads(args.config) or {})
    config.update(overrides)
    if args.packed > 1:
        batches, real, fill = packed_batches(config, args.batch, args.packed,
                                             args.tiny)
    else:
        batches = [example_batch(config, args.batch, args.time_steps)]
        real = [args.batch * args.time_steps]
    shard = make_shard_fn(device)
    batches = [shard(b) for b in batches]
    params, net_state = init_from_config(config, device)
    params = tree_map(lambda t: t.requires_grad_(), params)
    init_opt, train_step = make_train_step(config, 1e-3, "adam")
    opt_state = init_opt(params)
    generator = torch.Generator(device).manual_seed(1)

    def run(i):
        train_step(params, opt_state, net_state, generator,
                   batches[i % len(batches)])

    for i in range(max(2, len(batches))):  # warm every batch shape
        run(i)
    frames = sum(real[i % len(real)] for i in range(args.steps))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(args.steps):
            run(i)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        import time
        begin = time.perf_counter()
        for i in range(args.steps):
            run(i)
        seconds = time.perf_counter() - begin
    row = {"frames_per_sec": round(frames / seconds, 1)}
    if args.packed > 1:
        row["fill"] = round(fill, 4)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="A/B the flagship train step under nnet.config "
                    "variants, one subprocess per variant.")
    ap.add_argument("variants", nargs="*",
                    help="name=key=val[,key=val...] (empty: as shipped)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time-steps", type=int, default=384)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model dims (harness smoke test)")
    ap.add_argument("--packed", type=int, default=0, metavar="PF",
                    help="time packed rows at this pack factor (real "
                         "frames/s) instead of the unpacked batch")
    ap.add_argument("--config", default="{}",
                    help="JSON object merged over the flagship config")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        config_ok = isinstance(json.loads(args.config), dict)
    except json.JSONDecodeError:
        config_ok = False
    if not config_ok:
        ap.error("--config must be a JSON object")
    if args.run is not None:  # one variant, in this process
        print(json.dumps(run_variant(args, json.loads(args.run))),
              flush=True)
        return
    if not args.variants:
        ap.error("name at least one variant")
    try:
        variants = [parse_variant(spec) for spec in args.variants]
    except ValueError as exc:
        ap.error(str(exc))

    common = ["--batch", str(args.batch), "--time-steps",
              str(args.time_steps), "--steps", str(args.steps), "--packed",
              str(args.packed), "--config", args.config, "--device",
              args.device] + (["--tiny"] if args.tiny else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    results = {name: [] for name, _ in variants}
    for rep in range(args.repeats):
        for name, overrides in variants:
            cmd = [sys.executable, "-m", "lstm_ctc_tpu_torch.scripts."
                   "ab_train_step", "--run", json.dumps(overrides)] + common
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   env=env, cwd=ROOT, timeout=args.timeout)
            except subprocess.TimeoutExpired:
                print(json.dumps({"variant": name, "rep": rep,
                                  "error": "timeout after %ss"
                                           % args.timeout}), flush=True)
                continue
            if r.returncode != 0:
                print(json.dumps({"variant": name, "rep": rep,
                                  "error": r.stderr[-500:]}), flush=True)
                continue
            row = json.loads(r.stdout.strip().splitlines()[-1])
            results[name].append(row["frames_per_sec"])
            print(json.dumps(dict({"variant": name, "rep": rep}, **row)),
                  flush=True)

    summary = {name: {"best": max(vals), "runs": vals}
               for name, vals in results.items() if vals}
    names = [name for name, _ in variants if results[name]]
    if len(names) >= 2:
        base = max(results[names[0]])
        for name in names[1:]:
            summary[name]["vs_" + names[0]] = round(
                (max(results[name]) - base) / base * 100.0, 2)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
