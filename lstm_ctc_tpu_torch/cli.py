"""Shared plumbing for the port's command-line tools (counterpart of
``lstm_ctc_tpu/cli.py``).  torch is imported by the helpers that need it,
so the data tools that use this module start without it."""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Dict, Optional

from .host import logging_util as log
from .host.data import BucketedBatcher, scan_label_lengths, scan_scp


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def log_invocation(name: str, argv=None) -> None:
    log.info(" ".join(sys.argv if argv is None else [name] + list(argv)))


def resolve_device(arg: str) -> torch.device:
    """``cuda``, ``cuda:N`` or ``cpu``, logged with the card's name; under
    the launcher's environment ``cuda`` is this rank's card
    (``LOCAL_RANK``).  Asking for CUDA where there is no GPU raises: the
    run never carries on on the CPU."""
    import torch

    from .parallel import local_device
    device = local_device(torch.device(arg))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device %s: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)" % arg)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % arg)
    log.info("device %s%s" % (device, " (%s)" % torch.cuda.get_device_name(
        device) if device.type == "cuda" else ""))
    return device


def build_batcher(records_scp: str, config: Dict, batch_size: int,
                  need_labels: bool = True,
                  pack_factor: int = 1) -> BucketedBatcher:
    """Length-bucketed batches with the config's splice and subsampling;
    label lengths are read up front when the records carry labels.

    Packed batches lay their slots out rank-major; the code that owns the
    config and the batcher declares it (``packed_slots_rank_major``), as
    ``bin/nnet_train`` does, not this helper."""
    metas = scan_scp(records_scp)
    label_lengths = None
    if need_labels and metas and metas[0].has_label:
        label_lengths = scan_label_lengths(metas)
    return BucketedBatcher(
        metas,
        batch_size=batch_size,
        left_context=config.get("left_context", 0) or 0,
        right_context=config.get("right_context", 0) or 0,
        subsample=config.get("subsample", 0) or 0,
        label_lengths=label_lengths,
        pack_factor=pack_factor,
    )


def quiet_unless_rank0() -> None:
    """Under the launcher's environment only rank 0 logs the ``INFO:``
    lines and prints: every other rank's are dropped from here on."""
    if os.environ.get("RANK", "0") != "0":
        log.quiet()
        sys.stdout = open(os.devnull, "w")


@contextlib.contextmanager
def data_parallel(device: torch.device):
    """Within the block, the process group the launcher's environment
    describes, if any (``parallel.join``; left at the end if entered
    here); yields this process's rank, rank 0 alone logging."""
    from . import parallel
    quiet_unless_rank0()
    joined = parallel.join(device)
    rank = parallel.rank()
    try:
        yield rank
    finally:
        if joined:
            parallel.leave()


def spawn_over_cards(module: str, argv, device_arg: str) -> Optional[int]:
    """With more than one card visible, ``--device cuda`` and no launcher
    environment, run ``python -m module argv`` once per card as the
    standard launcher would (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), so that one call of a training tool
    trains on every card, as the reference takes every local device; waits
    for them and returns the first non-zero exit code (stopping the
    others), else 0.  Returns None, having started nothing, otherwise."""
    import socket
    import subprocess
    import time

    import torch
    from . import parallel
    if parallel.launched() or device_arg != "cuda" \
            or not torch.cuda.is_available() \
            or torch.cuda.device_count() < 2:
        return None
    count = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module] + list(argv),
        env=dict(os.environ, WORLD_SIZE=str(count), RANK=str(r),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(count),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 PYTHONPATH=root + (os.pathsep + path if path else "")))
        for r in range(count)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()


def make_shard_fn(device: torch.device):
    """Batch → dict of tensors on ``device``: the whole batch, or under a
    process group this rank's rows (``parallel.shard_batch``)."""
    from .parallel import shard_batch

    def shard_fn(batch):
        arrays = {
            "nnet_input": batch.nnet_input,
            "sequence_length": batch.sequence_length,
            "nnet_target": batch.nnet_target,
            "target_length": batch.target_length,
        }
        if getattr(batch, "reset_mask", None) is not None:
            arrays["reset_mask"] = batch.reset_mask
            arrays["utt_time_index"] = batch.utt_time_index
            arrays["utt_sequence_length"] = batch.utt_sequence_length
        return shard_batch(arrays, device)

    return shard_fn


def init_from_config(config: Dict, device="cpu"):
    """Deterministic model init seeded from the config's ``seed`` key."""
    import torch
    from .models import init_model
    seed = int(config.get("seed", 777) or 777)
    generator = torch.Generator().manual_seed(seed)
    return init_model(generator, config, device)


def check_objective_and_type(args, config: Dict) -> None:
    if args.objective != "ctc":
        log.fatal("unsupported objective: %s" % args.objective)
        sys.exit(1)
    nnet_type = config.get("nnet_type")
    if nnet_type not in ("blstm", "cudnnlstm", "lstm"):
        log.fatal("unsupported nnet_type: %s" % nnet_type)
        sys.exit(1)


@contextlib.contextmanager
def profile(profile_dir: Optional[str], device: torch.device):
    """With a directory, trace the block with ``torch.profiler`` (host, and
    the GPU on CUDA) and write a Chrome trace there; else do nothing."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The switches nnet_init, nnet_train and nnet_validate share with
    their ``bin/nnet-*.py`` counterparts, plus ``--device``."""
    parser.add_argument("--objective", metavar="objective", type=str,
                        default="xent", help="objective function.")
    parser.add_argument("--evaluate", metavar="evaluate", type=str2bool,
                        default="false",
                        help="whether to evaluate the model in addition to "
                             "loss.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=256, help="batch size.")
    parser.add_argument("--batch-threads", metavar="batch-threads", type=int,
                        default=8, help="accepted for compatibility.")
    parser.add_argument("--num-parallel-calls", metavar="num-parallel-calls",
                        type=int, default=32,
                        help="accepted for compatibility.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--device", metavar="device", type=str,
                        default="cuda", help="cuda, cuda:N or cpu.")


def validate(args, config: Dict, params, net_state, device) -> None:
    """One CV epoch over ``args.tfrecords_scp`` (nnet_init, nnet_validate)."""
    from .host.data import iterate_batches
    from .train.graph import make_eval_step
    from .train.loop import run_validation_epoch
    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size)
    run_validation_epoch(
        make_eval_step(config, with_logits=args.evaluate), params, net_state,
        iterate_batches(batcher, shuffle=False), make_shard_fn(device),
        evaluate=args.evaluate, report_interval=args.report_interval)
