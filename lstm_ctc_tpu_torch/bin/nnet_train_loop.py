"""In-process outer training loop ("oplr" newbob schedule, one process).

Port of ``bin/nnet-train-loop.py``, with the same switches plus
``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_train_loop \\
        --tr-tfrecords-scp tr.scp --cv-tfrecords-scp cv.scp \\
        --nnet-config nnet.config --dir exp/blstm --objective ctc \\
        --optimizer adam --learn-rate 1e-3 --batch-size 32 \\
        --pack-factor 3 [--device cuda]

The state machine of ``scripts/train_oplr.sh``, all iterations in one
process: accept or reject each epoch on the CV goal, learning-rate halving
with start / end / stop thresholds, ``--min-iters`` and
``--keep-lr-iters``, and one retry at a halved rate after a NaN loss.
Each epoch trains the best model so far with a fresh optimizer state (the
checkpoints hold the parameters only), and shuffles and draws its dropout
masks with the iteration number as the seed.  It writes the same
artifacts (``nnet.N`` checkpoints, ``nnet.N.done``, ``final.nnet``,
``nnet.N.metrics.jsonl``), prints the same lines, and resumes from the
``.done`` markers.

Over a process group (the standard launcher, or one process per card when
several are visible: ``cli.spawn_over_cards``) every rank runs the same
state machine on the global losses; rank 0 alone prints and writes, and
the others wait for its files at a barrier.

The train step updates the parameter tensors in place, so the best model
so far is kept as a detached copy and each epoch trains a copy of its own:
a rejected epoch must not leave its weights in the next one's start.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

from .. import cli, parallel
from ..host.config import parse_config
from ..host.data import iterate_batches
from ..models.cells import DropoutStreams
from ..train.checkpoint import load_checkpoint, save_checkpoint, tree_map
from ..train.graph import make_eval_step, make_train_step
from ..train.loop import (MetricsWriter, run_training_epoch,
                          run_validation_epoch)


def stamp() -> str:
    return time.strftime("[%Y/%m/%d %H:%M:%S]")


def detached_copy(tree):
    """The parameter tensors copied out of any later in-place update."""
    return tree_map(lambda t: t.detach().clone(), tree)


def read_done(path):
    vals = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 2:
                vals[parts[0]] = float(parts[1])
    return vals


def write_done(path, **vals):
    with open(path, "w") as fh:
        for k, v in vals.items():
            fh.write("%s %.6f\n" % (k, v))


def run(args) -> None:
    device = cli.resolve_device(args.device)
    with cli.data_parallel(device) as rank:
        train_loop(args, device, rank)


def train_loop(args, device, rank: int) -> None:
    lead = rank == 0   # rank 0 alone writes; the others read after a barrier
    outdir = args.dir
    config_dst = os.path.join(outdir, "nnet.config")
    if lead:
        os.makedirs(outdir, exist_ok=True)
        if os.path.realpath(args.nnet_config) != os.path.realpath(config_dst):
            with open(args.nnet_config) as src, open(config_dst, "w") as dst:
                dst.write(src.read())
    parallel.barrier()
    config = parse_config(config_dst)
    config["is_training"] = True
    cli.check_objective_and_type(args, config)

    tr_batcher = cli.build_batcher(args.tr_tfrecords_scp, config,
                                   args.batch_size,
                                   pack_factor=args.pack_factor)
    # the CV pass never packs (as nnet_validate)
    cv_config = dict(config)
    cv_batcher = cli.build_batcher(args.cv_tfrecords_scp, cv_config,
                                   args.batch_size)
    if args.pack_factor > 1:
        # only the training batcher packs, and it follows (and asserts)
        # the rank-major slot contract
        config["packed_slots_rank_major"] = True
    shard_fn = cli.make_shard_fn(device)
    eval_step = make_eval_step(cv_config, with_logits=True)

    def validate(params, net_state):
        stats = run_validation_epoch(
            eval_step, params, net_state,
            iterate_batches(cv_batcher, shuffle=False), shard_fn,
            evaluate=True, report_interval=args.report_interval)
        return float(stats.loss), float(stats.eval)

    def train_epoch(params, net_state, learn_rate, seed, metrics_path):
        init_opt, train_step = make_train_step(
            config, learn_rate=learn_rate, optimizer=args.optimizer,
            clip_norm=args.clip_norm)
        params = tree_map(
            lambda t: t.detach().clone().float().requires_grad_(), params)
        # fresh optimizer state every epoch: the checkpoints hold the
        # trainable parameters only
        opt_state = init_opt(params)
        writer = MetricsWriter(metrics_path if lead else None)
        try:
            params, _, net_state, stats = run_training_epoch(
                train_step, params, opt_state, net_state,
                iterate_batches(tr_batcher, shuffle=args.shuffle, seed=seed),
                shard_fn, DropoutStreams.for_rank(device, seed, rank),
                report_interval=args.report_interval, metrics_writer=writer)
        finally:
            writer.close()
        return detached_copy(params), net_state, float(stats.loss)

    template_params, template_state = cli.init_from_config(config, device)

    # ---- iteration 0: init + CV (train_oplr.sh:86-120) ----
    print("%s iteration 0" % stamp(), flush=True)
    nnet0 = os.path.join(outdir, "nnet.0")
    done0 = nnet0 + ".done"
    if os.path.exists(done0):
        params, net_state, _ = load_checkpoint(nnet0, template_params,
                                               template_state)
        vals = read_done(done0)
        cv_loss_best, cv_eval_best = vals["cv_loss"], vals["cv_eval"]
    else:
        params, net_state = template_params, template_state
        if lead:
            save_checkpoint(nnet0, params, net_state)
        cv_loss_best, cv_eval_best = validate(params, net_state)
        if lead:
            write_done(done0, cv_loss=cv_loss_best, cv_eval=cv_eval_best)
        parallel.barrier()
    cv_goal_best = cv_loss_best if args.cv_goal == "loss" else cv_eval_best
    print("cv_goal_best = %.6f" % cv_goal_best, flush=True)

    best_params, best_state = params, net_state
    best_name = "nnet.0"
    learn_rate = args.learn_rate
    halving = 0

    for it in range(1, args.max_iter + 1):
        nnet_out = os.path.join(outdir, "nnet.%d" % it)
        done = nnet_out + ".done"
        print("\n%s iteration %d" % (stamp(), it), flush=True)
        if os.path.exists(done):
            print("%s exists, skipping this iteration" % done, flush=True)
            vals = read_done(done)
            tr_loss = vals["tr_loss"]
            cv_loss, cv_eval = vals["cv_loss"], vals["cv_eval"]
            params, net_state, _ = load_checkpoint(
                nnet_out, template_params, template_state)
        else:
            print("training with learn_rate = %g" % learn_rate, flush=True)
            print("nnet_in = %s" % best_name, flush=True)
            print("nnet_out = %s" % nnet_out, flush=True)
            metrics_path = os.path.join(outdir, "nnet.%d.metrics.jsonl" % it)

            def attempt(lr):
                try:
                    return train_epoch(best_params, best_state, lr, it,
                                       metrics_path)
                except SystemExit:
                    return None   # NaN abort inside the epoch loop

            result = attempt(learn_rate)
            if result is None or not math.isfinite(result[2]):
                # NaN retry-once with halved LR (train_oplr.sh:145-159)
                learn_rate = learn_rate * args.halving_factor
                print("(ERROR) tr_loss = nan; reduce learn rate and "
                      "re-train\ntraining with learn_rate = %g"
                      % learn_rate, flush=True)
                result = attempt(learn_rate)
                if result is None or not math.isfinite(result[2]):
                    print("(ERROR) tr_loss = nan", flush=True)
                    sys.exit(1)
            params, net_state, tr_loss = result
            if lead:
                save_checkpoint(nnet_out, params, net_state)
            cv_loss, cv_eval = validate(params, net_state)
            if not (math.isfinite(cv_loss) and math.isfinite(cv_eval)):
                print("(ERROR) cv_loss = nan", flush=True)
                sys.exit(1)
            if lead:
                write_done(done, tr_loss=tr_loss, cv_loss=cv_loss,
                           cv_eval=cv_eval)
                with open(os.path.join(outdir, "final.nnet"), "w") as fh:
                    fh.write("nnet.%d\n" % it)
            parallel.barrier()
        print("tr_loss = %.6f cv_loss = %.6f cv_eval = %.6f"
              % (tr_loss, cv_loss, cv_eval), flush=True)

        cv_goal_val = cv_loss if args.cv_goal == "loss" else cv_eval
        # a collapsed run can reach a cv goal of exactly 0; a 0 best means
        # no relative improvement is measurable (the scripts' guarded awk)
        rel_impr = ((cv_goal_best - cv_goal_val)
                    / (cv_goal_best if cv_goal_best != 0 else 1e-20))
        print("cv_goal_val = %.6f cv_goal_best = %.6f relative "
              "improvement = %.6f" % (cv_goal_val, cv_goal_best, rel_impr),
              flush=True)

        if cv_goal_val < cv_goal_best:
            best_params, best_state = params, net_state
            best_name = "nnet.%d" % it
            cv_goal_best = cv_goal_val
            print("nnet accepted (%s)" % best_name, flush=True)
        else:
            print("nnet rejected (nnet.%d)" % it, flush=True)

        if it <= args.keep_lr_iters:
            continue

        if halving == 1 and rel_impr < args.end_halving_impr:
            if it <= args.min_iters:
                print("supposed to finish, but we continue as "
                      "min_iters = %d" % args.min_iters, flush=True)
                learn_rate = max(learn_rate * args.halving_factor,
                                 args.min_learning_rate)
                print("halved learning rate to %g" % learn_rate, flush=True)
                continue
            print("finished, too small rel. improvement %g < %g"
                  % (rel_impr, args.end_halving_impr), flush=True)
            break

        if halving == 0 and rel_impr < args.start_halving_impr:
            print("start halving learning rate, small rel. improvement "
                  "%g < %g" % (rel_impr, args.start_halving_impr),
                  flush=True)
            halving = 1

        if rel_impr > args.stop_halving_impr:
            print("stop halving learning rate, big rel. improvement "
                  "%g > %g" % (rel_impr, args.stop_halving_impr),
                  flush=True)
            halving = 0

        if halving == 1:
            learn_rate = max(learn_rate * args.halving_factor,
                             args.min_learning_rate)
            print("halved learning rate to %g" % learn_rate, flush=True)

    if lead:
        with open(os.path.join(outdir, "final.nnet"), "w") as fh:
            fh.write("%s\n" % best_name)
    parallel.barrier()
    print("%s training finished, the final model is %s/%s"
          % (stamp(), outdir, best_name), flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--tr-tfrecords-scp", required=True, type=str)
    parser.add_argument("--cv-tfrecords-scp", required=True, type=str)
    parser.add_argument("--nnet-config", required=True, type=str)
    parser.add_argument("--dir", required=True, type=str)
    parser.add_argument("--objective", type=str, default="xent")
    parser.add_argument("--optimizer", type=str, default="momentum")
    parser.add_argument("--learn-rate", type=float, default=0.008)
    parser.add_argument("--max-iter", type=int, default=30)
    parser.add_argument("--min-iters", type=int, default=30)
    parser.add_argument("--keep-lr-iters", type=int, default=0)
    parser.add_argument("--start-halving-impr", type=float, default=0.001)
    parser.add_argument("--end-halving-impr", type=float, default=0.0001)
    parser.add_argument("--stop-halving-impr", type=float, default=0.01)
    parser.add_argument("--halving-factor", type=float, default=0.5)
    parser.add_argument("--min-learning-rate", type=float, default=1e-5)
    parser.add_argument("--shuffle", type=cli.str2bool, default="false")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--clip-norm", type=float, default=5.0)
    parser.add_argument("--cv-goal", type=str, default="eval",
                        choices=["loss", "eval"])
    parser.add_argument("--pack-factor", type=int, default=1)
    parser.add_argument("--report-interval", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, cuda:N or cpu.")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    code = cli.spawn_over_cards(
        "lstm_ctc_tpu_torch.bin.nnet_train_loop",
        sys.argv[1:] if argv is None else argv, args.device)
    if code is not None:
        sys.exit(code)
    cli.quiet_unless_rank0()
    cli.log_invocation("nnet_train_loop", argv)
    run(args)


if __name__ == "__main__":
    main()
