"""Accumulate CMVN statistics (Kaldi compute-cmvn-stats equivalent).

Port of ``bin/compute-cmvn-stats.py``, with the same flags and
specifiers:

    python -m lstm_ctc_tpu_torch.bin.compute_cmvn_stats <feats-rspec> <stats-wxfilename>
    python -m lstm_ctc_tpu_torch.bin.compute_cmvn_stats --spk2utt=ark:spk2utt <feats-rspec> <wspec>
    python -m lstm_ctc_tpu_torch.bin.compute_cmvn_stats --per-utt=true <feats-rspec> <wspec>
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.data.features import accumulate_cmvn_stats
from ..host.featbin import parse_kaldi_flags

SPEC = {"spk2utt": (str, ""), "per_utt": (bool, False), "binary": (bool, True)}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 2:
        log.die("usage: compute-cmvn-stats.py [opts] <rspec> <out>")
    in_rspec, out = args

    if opts["per_utt"]:
        with kaldi.TableWriter(out, "matrix_double") as writer:
            for key, mat in kaldi.SequentialTableReader(in_rspec, "matrix"):
                writer.Write(key, accumulate_cmvn_stats(
                    np.asarray(mat, np.float32)))
        return

    if opts["spk2utt"]:
        src = opts["spk2utt"]
        src = src.split(":", 1)[1] if ":" in src else src
        utt2spk = {}
        spk_order = []
        with open(src) as fh:
            for line in fh:
                parts = line.split()
                if parts:
                    spk_order.append(parts[0])
                    for utt in parts[1:]:
                        utt2spk[utt] = parts[0]
        per_spk = {}
        for key, mat in kaldi.SequentialTableReader(in_rspec, "matrix"):
            spk = utt2spk.get(key)
            if spk is None:
                log.warning("utterance %s not in spk2utt, skipped" % key)
                continue
            per_spk[spk] = accumulate_cmvn_stats(
                np.asarray(mat, np.float32), per_spk.get(spk))
        with kaldi.TableWriter(out, "matrix_double") as writer:
            for spk in spk_order:
                if spk in per_spk:
                    writer.Write(spk, per_spk[spk])
        return

    stats = None
    for key, mat in kaldi.SequentialTableReader(in_rspec, "matrix"):
        stats = accumulate_cmvn_stats(np.asarray(mat, np.float32), stats)
    if stats is None:
        log.die("no features read from %s" % in_rspec)
    with kaldi.Output(out, binary=opts["binary"]) as outp:
        kaldi.write_matrix(outp.stream(), opts["binary"], stats, double=True)
    log.info("accumulated CMVN stats over %.0f frames"
             % stats[0, -1])


if __name__ == "__main__":
    main()
