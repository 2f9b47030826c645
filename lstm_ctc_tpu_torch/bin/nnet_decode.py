"""Greedy or beam CTC decoding to an Int32Vector archive (the debug/PER path).

Port of ``bin/nnet-decode.py``, with the same positional arguments and
flags plus ``--device`` (default ``cuda``; there is no silent CPU run):

    python -m lstm_ctc_tpu_torch.bin.nnet_decode <records-scp> \\
        <nnet-config> <nnet-in> <output-wspecifier> [--beam-width 1] \\
        [--batch-size 16] [--device cuda]

The model's forward and the log-softmax run on the device; the decoding
runs on the host: greedy (``--beam-width 1``, ``host.decode.greedy_decode``)
or the prefix beam search (``host.decode.beam_search_decode``: the native
``libctc_beam.so`` of the port's native build unless
``LSTM_CTC_TPU_NATIVE_BEAM=0``, else its Python specification).  Used by
the debug decode of ``scripts/decode.sh``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import build_batcher, init_from_config, log_invocation, \
    resolve_device
from ..host import kaldi
from ..host import logging_util as log
from ..host.config import parse_config
from ..host.data import iterate_batches
from ..host.decode import beam_search_decode, greedy_decode
from ..models import apply_model
from ..train.checkpoint import load_checkpoint


def decode(args) -> int:
    """Decode every utterance; returns the number of hypotheses written."""
    device = resolve_device(args.device)
    config = parse_config(args.nnet_config)
    config["is_training"] = False
    template_params, template_state = init_from_config(config, device)
    params, net_state, _ = load_checkpoint(args.nnet_in, template_params,
                                           template_state)
    batcher = build_batcher(args.tfrecords_scp, config, args.batch_size,
                            need_labels=False)
    writer = kaldi.Int32VectorWriter(args.output)
    processed = 0
    with torch.inference_mode():
        for batch in iterate_batches(batcher, shuffle=False):
            logits, _, _, _ = apply_model(
                params, net_state,
                torch.from_numpy(batch.nnet_input).to(device),
                torch.from_numpy(batch.sequence_length).to(device), config)
            log_probs = torch.log_softmax(logits.float(), dim=-1).cpu() \
                .numpy()
            count = len(batch.keys)
            if args.beam_width > 1:
                hyps = [beam_search_decode(
                            log_probs[b, :int(batch.sequence_length[b])],
                            beam_width=args.beam_width)[0]
                        for b in range(count)]
            else:
                hyps = greedy_decode(log_probs[:count],
                                     batch.sequence_length[:count])
            for key, hyp in zip(batch.keys, hyps):
                writer.Write(key, np.asarray(hyp, np.int32))
                processed += 1
                if args.report_interval \
                        and processed % args.report_interval == 0:
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
    parser.add_argument("output", metavar="<output-wspecifier>", type=str,
                        help="wspecifier for decoded label sequences.")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--beam-width", metavar="beam-width", type=int,
                        default=1,
                        help="CTC beam width; 1 = greedy.")
    parser.add_argument("--batch-size", metavar="batch-size", type=int,
                        default=16, help="inference batch size.")
    parser.add_argument("--device", metavar="device", type=str,
                        default="cuda", help="cuda, cuda:N or cpu.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log_invocation("nnet_decode", argv)
    return decode(args)


if __name__ == "__main__":
    main()
