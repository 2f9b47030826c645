"""Initialize a model: random init + one CV pass, saved as iteration 0.

Port of ``bin/nnet-init.py``, with the same positional arguments and
switches plus ``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_init <records-scp> \\
        <nnet-config> <nnet-out> --objective ctc [--device cuda]

The initial cross-validation gives the outer training loop its starting
``cv_loss``.
"""

from __future__ import annotations

import argparse

from .. import cli
from ..host import logging_util as log
from ..host.config import parse_config
from ..train.checkpoint import save_checkpoint


def run(args) -> None:
    device = cli.resolve_device(args.device)
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    cli.check_objective_and_type(args, config)
    params, net_state = cli.init_from_config(config, device)
    cli.validate(args, config, params, net_state, device)
    log.info('saving nnet to "%s"' % args.nnet_out)
    save_checkpoint(args.nnet_out, params, net_state)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_out", metavar="<nnet-out>", type=str,
                        help="nnet-out.")
    cli.add_common_args(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cli.log_invocation("nnet_init", argv)
    run(args)


if __name__ == "__main__":
    main()
