"""Apply cepstral mean (and variance) normalization (Kaldi apply-cmvn).

Port of ``bin/apply-cmvn.py``, with the same flags and specifiers:

    python -m lstm_ctc_tpu_torch.bin.apply_cmvn [--norm-means=true] \\
        [--norm-vars=false] [--utt2spk=ark:utt2spk] \\
        (<stats-rxfilename>|<stats-rspecifier>) <in-rspec> <out-wspec>
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import kaldi
from ..host import logging_util as log
from ..host.data.features import apply_cmvn
from ..host.featbin import parse_kaldi_flags

SPEC = {
    "norm_means": (bool, True),
    "norm_vars": (bool, False),
    "utt2spk": (str, ""),
}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if len(args) != 3:
        log.die("usage: apply-cmvn.py [opts] <stats> <rspec> <wspec>")
    stats_src, in_rspec, out_wspec = args

    utt2spk = {}
    if opts["utt2spk"]:
        src = opts["utt2spk"]
        src = src.split(":", 1)[1] if ":" in src else src
        with open(src) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) == 2:
                    utt2spk[parts[0]] = parts[1]

    per_key_stats = None
    global_stats = None
    if stats_src.startswith(("ark", "scp")):
        per_key_stats = kaldi.RandomAccessTableReader(stats_src, "matrix")
    else:
        with kaldi.Input(stats_src) as inp:
            global_stats = kaldi.read_matrix(inp.stream(), inp.binary)

    done = 0
    with kaldi.TableWriter(out_wspec, "matrix") as writer:
        for key, mat in kaldi.SequentialTableReader(in_rspec, "matrix"):
            if global_stats is not None:
                stats = global_stats
            else:
                stats_key = utt2spk.get(key, key)
                if not per_key_stats.HasKey(stats_key):
                    log.warning("no CMVN stats for %s, skipping" % key)
                    continue
                stats = per_key_stats.Value(stats_key)
            writer.Write(key, apply_cmvn(
                np.asarray(mat, np.float32), np.asarray(stats, np.float64),
                opts["norm_means"], opts["norm_vars"]))
            done += 1
    log.info("applied CMVN to %d utterances" % done)


if __name__ == "__main__":
    main()
