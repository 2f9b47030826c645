"""Train an ARPA n-gram LM (interpolated modified Kneser-Ney + pruning).

Port of ``bin/train-lm.py``, with the same arguments; the ARPA goes to
standard output:

    python -m lstm_ctc_tpu_torch.bin.train_lm --order 3 data/train/text > lm.arpa
    python -m lstm_ctc_tpu_torch.bin.train_lm --order 3 --prune 1e-7 \\
        --wordlist words.list text > tgpr.arpa

Counting runs in C++ (``count-ngrams`` of the port's native build) when
``lstm_ctc_tpu_torch._native`` has built it, else in Python, with the same
counts; estimation on the (cut-off) counts is Python (``host/lm``).
"""

from __future__ import annotations

import argparse
import sys

from ..host.lm import perplexity, write_arpa
from ..host.lm.ngram import (count_ngrams_file, estimate_from_counts,
                             read_sentences)


def train(args) -> None:
    min_counts = [int(c) for c in args.min_counts.split(",")] \
        if args.min_counts else None
    raw = count_ngrams_file(args.text, args.order,
                            vocab_path=args.wordlist,
                            kaldi_text=not args.plain_text,
                            min_counts=min_counts)
    lm = estimate_from_counts(raw, args.order,
                              prune_threshold=args.prune)
    write_arpa(lm, sys.stdout)
    if args.ppl_text:
        heldout = list(read_sentences(args.ppl_text,
                                      kaldi_text=not args.plain_text))
        print("train-lm: heldout perplexity %.2f over %d sentences"
              % (perplexity(lm, heldout), len(heldout)), file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ARPA LM trainer (interpolated modified Kneser-Ney)")
    parser.add_argument("text", help="training text (kaldi 'utt w1 w2...' "
                        "format unless --plain-text); - for stdin, .gz ok")
    parser.add_argument("--order", type=int, default=3)
    parser.add_argument("--wordlist", default=None,
                        help="vocabulary file (first column); OOVs → <unk>")
    parser.add_argument("--prune", type=float, default=0.0,
                        help="relative-entropy pruning threshold "
                        "(e.g. 1e-7; 0 = no pruning)")
    parser.add_argument("--min-counts", default=None,
                        help="comma list of per-order count cutoffs, "
                        "e.g. 1,1,2")
    parser.add_argument("--plain-text", action="store_true",
                        help="lines are raw sentences without utt ids")
    parser.add_argument("--ppl-text", default=None,
                        help="report held-out perplexity on this text "
                        "to stderr")
    return parser


def main(argv=None) -> None:
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
