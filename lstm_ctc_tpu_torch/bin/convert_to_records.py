"""Convert Kaldi feature/label tables into utterance record shards + scp.

Port of ``bin/convert-to-records.py`` (and of ``bin/convert-to-tfrecords.py``,
a byte-identical copy of it), with the same positional arguments and
flags:

    python -m lstm_ctc_tpu_torch.bin.convert_to_records \\
        <nnet-input-rspecifier> <records-dir> <records.scp> \\
        [--nnet-target <rspec>] [--target-length-cutoff N] \\
        [--check-length bool] [--report-interval N] [--shard-name name]

  * skip utterances with missing or empty labels;
  * fatal on feature/label length mismatch under --check-length;
  * skip when the label count >= the frame count (CTC infeasibility);
  * skip when the label count <= --target-length-cutoff.

The feature rspecifier may be a pipe ("ark:copy-feats ... | apply-cmvn ...
|"), handled by the Kaldi streams layer.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..cli import log_invocation, str2bool
from ..host import kaldi
from ..host import logging_util as log
from ..host.data import RecordShardWriter


def convert(args) -> int:
    """Write the shard and its scp; returns the utterances written."""
    feats_reader = kaldi.SequentialBaseFloatMatrixReader(args.nnet_input)
    target_reader = kaldi.RandomAccessInt32VectorReader(args.nnet_target) \
        if args.nnet_target is not None else None

    os.makedirs(args.tfrecords_dir, exist_ok=True)
    shard_path = os.path.join(args.tfrecords_dir,
                              "%s.rec" % args.shard_name)
    processed = 0
    with RecordShardWriter(shard_path) as writer, \
            open(args.tfrecords_scp, "w") as scp:
        for key, feats in feats_reader:
            target = None
            if target_reader is not None:
                if not target_reader.HasKey(key):
                    log.info('missing nnet targets for "%s" in %s'
                             % (key, args.nnet_target))
                    continue
                target = target_reader.Value(key)
                if target.shape[0] == 0:
                    log.info('length of nnet targets for "%s" is 0 in %s'
                             % (key, args.nnet_target))
                    continue
                if args.check_length and \
                        feats.shape[0] != target.shape[0]:
                    log.fatal(
                        "mismatched sizes between nnet_input and "
                        "nnet_target: %s vs. %s"
                        % (feats.shape, target.shape))
                    sys.exit(1)
                if target.shape[0] >= feats.shape[0]:
                    log.info(
                        'nnet_input.shape = %s nnet_target.shape = %s for '
                        '"%s" in %s' % (feats.shape, target.shape, key,
                                        args.nnet_target))
                    continue
                if target.shape[0] <= args.target_length_cutoff:
                    log.info('nnet_target shape = %s for "%s" in %s is '
                             'too short'
                             % (target.shape, key, args.nnet_target))
                    continue
            meta = writer.write(key, np.asarray(feats, np.float32), target)
            scp.write(meta.scp_line())
            processed += 1
            if args.report_interval and \
                    processed % args.report_interval == 0:
                log.info("processed = %d" % processed)
    feats_reader.Close()
    if target_reader is not None:
        target_reader.Close()
    log.info("done, %d utterances" % processed)
    return processed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("nnet_input", metavar="<nnet-input-rspecifier>",
                        type=str, help="rspecifier for nnet input features.")
    parser.add_argument("tfrecords_dir", metavar="<tfrecords-dir>", type=str,
                        help="directory for record shards.")
    parser.add_argument("tfrecords_scp", metavar="<tfrecords.scp>", type=str,
                        help="output scp.")
    parser.add_argument("--nnet-target", metavar="<nnet-target-rspecifier>",
                        type=str, default=None,
                        help="rspecifier for nnet targets.")
    parser.add_argument("--target-length-cutoff",
                        metavar="target length cut off", type=int, default=0,
                        help="skip utterances whose label count is <= this.")
    parser.add_argument("--check-length", metavar="check-length",
                        type=str2bool, default="false",
                        help="fatal on feature/label length mismatch "
                             "(framewise alignments).")
    parser.add_argument("--report-interval", metavar="report-interval",
                        type=int, default=100,
                        help="progress report interval.")
    parser.add_argument("--shard-name", metavar="shard-name", type=str,
                        default="records",
                        help="basename of the shard file to write.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log_invocation("convert_to_records", argv)
    return convert(args)


if __name__ == "__main__":
    main()
