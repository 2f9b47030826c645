"""Forward pass: write (log-)posteriors as a Kaldi matrix archive.

Port of ``bin/nnet-forward.py``, with the same positional arguments and
flags plus ``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_forward <records-scp> \\
        <nnet-config> <nnet-in> <nnet-output-wspecifier> [--device cuda]

  * posterior = softmax(smooth_factor · logits);
  * ``--apply-log`` implies softmax and takes the log;
  * ``--class-prior`` subtracts the (blank-rotated) log prior;
  * utterances are batched through the length-bucketed pipeline and
    written per key through any Kaldi wspecifier;
  * ``--streaming true`` runs a causal model (``lstm``, ``cudnnlstm``)
    utterance by utterance through one ``StreamingSession`` in chunks of
    ``--chunk-frames`` model rows (after splice and subsampling); a
    ``blstm`` is refused.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli import build_batcher, init_from_config, resolve_device, str2bool
from ..host import kaldi
from ..host import logging_util as log
from ..host.config import parse_config
from ..host.data import iterate_batches, iterate_utterances, scan_scp
from ..host.class_prior import get_class_prior, subtract_log_prior
from ..models import apply_model
from ..train.checkpoint import load_checkpoint


def forward(args) -> int:
    """Run the forward pass; returns the number of utterances written."""
    device = resolve_device(args.device)
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    if args.apply_log:
        args.apply_softmax = True
    class_prior = None if args.class_prior is None else \
        get_class_prior(args.class_prior)

    template_params, template_state = init_from_config(config, device)
    params, net_state, _ = load_checkpoint(args.nnet_in, template_params,
                                           template_state)
    if args.streaming:
        return _forward_streaming(args, config, params, net_state,
                                  class_prior)
    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size,
                            need_labels=False)
    writer = kaldi.BaseFloatMatrixWriter(args.nnet_output)
    processed = 0
    with torch.inference_mode():
        for batch in iterate_batches(batcher, shuffle=False):
            nnet_input = torch.from_numpy(batch.nnet_input).to(device)
            sequence_length = torch.from_numpy(batch.sequence_length).to(
                device)
            logits, _, _, _ = apply_model(params, net_state, nnet_input,
                                          sequence_length, config)
            if args.apply_softmax:
                logits = torch.softmax(args.smooth_factor * logits, dim=-1)
            out = logits.cpu().numpy()
            if args.apply_log:
                with np.errstate(divide="ignore"):
                    out = np.log(out)
            if class_prior is not None:
                out = subtract_log_prior(out, class_prior)
            for row, key in enumerate(batch.keys):
                t_len = int(batch.sequence_length[row])
                writer.Write(key, out[row, :t_len].astype(np.float32))
                processed += 1
                if args.report_interval \
                        and processed % args.report_interval == 0:
                    log.info("processed = %d" % processed)
    log.info("done")
    writer.Close()
    return processed


def _forward_streaming(args, config, params, net_state, class_prior) -> int:
    """``bin/nnet-forward.py --streaming`` (:64-87): one session for the
    whole archive, reset between utterances; each utterance's raw frames
    go in at once and the session splices, subsamples and chunks them."""
    from ..models.streaming import StreamingSession
    session = StreamingSession(params, net_state, config,
                               chunk_size=args.chunk_frames)
    writer = kaldi.BaseFloatMatrixWriter(args.nnet_output)
    processed = 0
    for key, raw, _ in iterate_utterances(scan_scp(args.tfrecords_scp)):
        session.reset()
        out = session.process(raw, flush=True)
        if args.apply_softmax:
            z = args.smooth_factor * out
            e = np.exp(z - z.max(axis=1, keepdims=True))
            out = e / e.sum(axis=1, keepdims=True)
        if args.apply_log:
            with np.errstate(divide="ignore"):
                out = np.log(out)
        if class_prior is not None:
            out = subtract_log_prior(out, class_prior)
        writer.Write(key, out.astype(np.float32))
        processed += 1
        if args.report_interval and processed % args.report_interval == 0:
            log.info("processed = %d" % processed)
    log.info("done")
    writer.Close()
    return processed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("tfrecords_scp", metavar="<tfrecords-scp>", type=str,
                        help="records scp.")
    parser.add_argument("nnet_config", metavar="<nnet-config>", type=str,
                        help="nnet-config.")
    parser.add_argument("nnet_in", metavar="<nnet-in>", type=str,
                        help="nnet-in.")
    parser.add_argument("nnet_output", metavar="<nnet-output-wspecifier>",
                        type=str, help="wspecifier for nnet-output.")
    parser.add_argument("--apply-softmax", metavar="apply-softmax",
                        type=str2bool, default="true",
                        help="whether to apply softmax.")
    parser.add_argument("--apply-log", metavar="apply-log",
                        type=str2bool, default="true",
                        help="whether to apply log on top of softmax")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--class-prior", metavar="class-prior", type=str,
                        default=None,
                        help="class prior to scale the softmax output")
    parser.add_argument("--smooth-factor", metavar="smooth factor",
                        type=float, default=1.0,
                        help="smooth factor for softmax")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=16, help="inference batch size.")
    parser.add_argument("--streaming", metavar="streaming", type=str2bool,
                        default="false",
                        help="chunked causal streaming inference "
                             "(lstm/cudnnlstm).")
    parser.add_argument("--chunk-frames", metavar="chunk-frames", type=int,
                        default=32,
                        help="streaming chunk size (model rows, after "
                             "splice and subsampling).")
    parser.add_argument("--device", metavar="device", type=str,
                        default="cuda", help="cuda, cuda:N or cpu.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log.info(" ".join(sys.argv if argv is None
                      else ["nnet_forward"] + list(argv)))
    return forward(args)


if __name__ == "__main__":
    main()
