"""Cross-validate a model: one CV epoch, logs cv_loss (and cv_eval).

Port of ``bin/nnet-validate.py``, with the same positional arguments and
switches plus ``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_validate <records-scp> \\
        <nnet-config> <nnet-in> --objective ctc [--device cuda]

Over a process group (the standard launcher, or one process per card when
several are visible: ``cli.spawn_over_cards``) each rank evaluates its
rows of every batch and the losses are summed over the ranks.
"""

from __future__ import annotations

import argparse
import sys

from .. import cli
from ..host.config import parse_config
from ..train.checkpoint import load_checkpoint


def run(args) -> None:
    device = cli.resolve_device(args.device)
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    cli.check_objective_and_type(args, config)
    with cli.data_parallel(device):
        template_params, template_state = cli.init_from_config(config, device)
        params, net_state, _ = load_checkpoint(args.nnet_in, template_params,
                                               template_state)
        cli.validate(args, config, params, net_state, device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    cli.add_common_args(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    code = cli.spawn_over_cards(
        "lstm_ctc_tpu_torch.bin.nnet_validate",
        sys.argv[1:] if argv is None else argv, args.device)
    if code is not None:
        sys.exit(code)
    cli.quiet_unless_rank0()
    cli.log_invocation("nnet_validate", argv)
    run(args)


if __name__ == "__main__":
    main()
