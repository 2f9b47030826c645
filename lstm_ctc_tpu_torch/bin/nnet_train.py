"""Train one epoch of CTC and save the updated model.

Port of ``bin/nnet-train.py``, with the same positional arguments and
switches plus ``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_train <records-scp> \\
        <nnet-config> <nnet-in> <nnet-out> --objective ctc \\
        --optimizer adam --learn-rate 1e-3 [--pack-factor 3] [--device cuda]

Restores the parameters only: the optimizer state is made fresh for each
epoch, as the reference does.  Trains one full pass, logs the ``tr_loss``
line and saves the shared ``.npz`` checkpoint.  ``--profile-dir`` writes
a ``torch.profiler`` trace of the epoch.

Data parallel as the reference is over every local device: under the
standard launcher (``python -m torch.distributed.run --nproc_per_node N
-m lstm_ctc_tpu_torch.bin.nnet_train ...``) each rank trains its rows of
every batch; with several cards visible and no launcher, one process per
card is started (``cli.spawn_over_cards``).  Rank 0 logs and saves.
"""

from __future__ import annotations

import argparse
import sys

from .. import cli, parallel
from ..host import logging_util as log
from ..host.config import parse_config
from ..host.data import iterate_batches
from ..models.cells import DropoutStreams
from ..train.checkpoint import load_checkpoint, save_checkpoint, tree_map
from ..train.graph import make_train_step
from ..train.loop import MetricsWriter, run_training_epoch


def run(args) -> None:
    device = cli.resolve_device(args.device)
    with cli.data_parallel(device) as rank:
        train(args, device, rank)


def train(args, device, rank: int) -> None:
    config = parse_config(args.nnet_config)
    config["is_training"] = True
    cli.check_objective_and_type(args, config)
    template_params, template_state = cli.init_from_config(config, device)
    params, net_state, _ = load_checkpoint(args.nnet_in, template_params,
                                           template_state)
    params = tree_map(lambda t: t.float().requires_grad_(), params)

    batcher = cli.build_batcher(args.tfrecords_scp, config, args.batch_size,
                                pack_factor=args.pack_factor)
    if args.pack_factor > 1:
        # every packed batch of this run comes from the batcher above,
        # which follows (and asserts) the rank-major slot contract
        config["packed_slots_rank_major"] = True
    init_opt, train_step = make_train_step(
        config, learn_rate=args.learn_rate, optimizer=args.optimizer,
        clip_norm=args.clip_norm)
    opt_state = init_opt(params)
    streams = DropoutStreams.for_rank(device, args.seed, rank)
    metrics_writer = MetricsWriter(args.metrics_file if rank == 0 else None)
    try:
        with cli.profile(args.profile_dir if rank == 0 else None, device):
            params, opt_state, net_state, _ = run_training_epoch(
                train_step, params, opt_state, net_state,
                iterate_batches(batcher, shuffle=args.shuffle,
                                seed=args.seed),
                cli.make_shard_fn(device), streams,
                report_interval=args.report_interval,
                metrics_writer=metrics_writer)
    finally:
        metrics_writer.close()
    parallel.barrier()
    if rank == 0:
        log.info('saving nnet to "%s"' % args.nnet_out)
        save_checkpoint(args.nnet_out, params, net_state)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    parser.add_argument("nnet_out", metavar="<nnet-out>", type=str,
                        help="nnet-out.")
    cli.add_common_args(parser)
    parser.add_argument("--optimizer", metavar="optimizer", type=str,
                        default="sgd", help="optimizer to be used.")
    parser.add_argument("--learn-rate", metavar="learn-rate", type=float,
                        default=0.0001, help="learning rate.")
    parser.add_argument("--seed", metavar="seed", type=int, default=777,
                        help="seed for shuffling and dropout.")
    parser.add_argument("--shuffle", metavar="do shuffle in the training",
                        type=cli.str2bool, default="true",
                        help="whether to shuffle training data.")
    parser.add_argument("--clip-norm", metavar="gradient clip norm",
                        type=float, default=5.0, help="gradient clip norm")
    parser.add_argument("--pack-factor", metavar="pack-factor", type=int,
                        default=1,
                        help="pack up to N utterances per row with state "
                             "resets (blstm only).")
    parser.add_argument("--metrics-file", metavar="metrics-file", type=str,
                        default=None,
                        help="write per-step scalar metrics as JSONL.")
    parser.add_argument("--profile-dir", metavar="profile-dir", type=str,
                        default=None,
                        help="write a torch.profiler trace of this epoch.")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    code = cli.spawn_over_cards(
        "lstm_ctc_tpu_torch.bin.nnet_train",
        sys.argv[1:] if argv is None else argv, args.device)
    if code is not None:
        sys.exit(code)
    cli.quiet_unless_rank0()
    cli.log_invocation("nnet_train", argv)
    run(args)


if __name__ == "__main__":
    main()
