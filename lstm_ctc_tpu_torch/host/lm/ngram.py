"""N-gram LM estimation: interpolated modified Kneser-Ney + pruning.

The port's copy of ``lstm_ctc_tpu/lm/ngram.py`` (standard library only);
its native counter is the port's build (``lstm_ctc_tpu_torch/_native.py``).

Native replacement for the kaldi_lm/SRILM/IRSTLM toolchain the reference
recipes shell out to (reference local/wsj_train_lms.sh:1 trains the WSJ
LMs with kaldi_lm's train_lm.sh; IRSTLM prune-lm produces the "pruned"
tgpr variants, reference egs/wsj/run_wsj_phn.sh:34-39).  Implements the
Chen & Goodman interpolated modified-KN estimator with count-of-count
discounts and SRILM-style relative-entropy pruning, emitting standard
ARPA consumable by arpa2fst / arpa-to-const-arpa.

Scale: pure-Python dict counting — fine for recipe-scale corpora (tens
of millions of tokens train in minutes); the output formats are the
interchange point, so a faster external estimator can be dropped in
without touching anything downstream.
"""

from __future__ import annotations

import gzip
import math
import sys
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
UNK_UPPER = "<UNK>"   # Kaldi wordlist convention


def _unk_symbol(vocab) -> str:
    """The OOV token matching the wordlist's convention: Kaldi
    dictionaries carry '<UNK>', SRILM-style lists '<unk>'.  A mismatch
    silently drops every OOV n-gram as out-of-symbol-table when the
    ARPA is compiled against words.txt."""
    if vocab:
        if UNK in vocab:
            return UNK
        if UNK_UPPER in vocab:
            return UNK_UPPER
    return UNK


LOG10 = math.log(10.0)


def _open(path):
    if path == "-":
        return sys.stdin
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def read_sentences(path: str, kaldi_text: bool = True) -> Iterable[List[str]]:
    """Yield token lists; kaldi_text drops the leading utterance id."""
    with _open(path) as fh:
        for line in fh:
            toks = line.split()
            if kaldi_text and toks:
                toks = toks[1:]
            if toks:
                yield toks


class NgramLm:
    """In-memory ARPA-style backoff LM.

    ``probs[k]`` maps k-gram tuples to log10 p(w|h); ``bows[k]`` maps
    k-gram history tuples to log10 backoff weights.
    """

    def __init__(self, order: int):
        self.order = order
        self.probs: List[Dict[Tuple[str, ...], float]] = [
            {} for _ in range(order + 1)]      # index by n-gram length
        self.bows: List[Dict[Tuple[str, ...], float]] = [
            {} for _ in range(order + 1)]

    def logprob(self, history: Sequence[str], word: str) -> float:
        """Backoff log10 p(word | history); OOV words get the <unk> /
        <UNK> probability when present, else -99."""
        vocab_word = word
        if (vocab_word,) not in self.probs[1]:
            for unk in (UNK, UNK_UPPER):
                if (unk,) in self.probs[1]:
                    vocab_word = unk
                    break
        if (vocab_word,) not in self.probs[1]:
            return -99.0
        h = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        backoff = 0.0
        while True:
            gram = h + (vocab_word,)
            p = self.probs[len(gram)].get(gram)
            if p is not None:
                return backoff + p
            if not h:
                return -99.0
            backoff += self.bows[len(h)].get(h, 0.0)
            h = h[1:]

    def sentence_logprob(self, words: Sequence[str]) -> float:
        seq = [BOS] + list(words) + [EOS]
        total = 0.0
        for i in range(1, len(seq)):
            total += self.logprob(seq[max(0, i - self.order + 1):i], seq[i])
        return total


def _count_ngrams(sentences: Iterable[Sequence[str]], order: int,
                  vocab: Optional[set] = None):
    """Raw counts per order; single-<s> padding (SRILM convention: grams
    never extend left of the sentence start), OOVs → <unk>."""
    counts = [Counter() for _ in range(order + 1)]
    unk = _unk_symbol(vocab)
    for sent in sentences:
        toks = [w if (vocab is None or w in vocab) else unk for w in sent]
        seq = [BOS] + toks + [EOS]
        counts[1][(BOS,)] += 1           # <s> hosts a bow, never predicted
        for i in range(1, len(seq)):
            for k in range(1, order + 1):
                if i - k + 1 < 0:
                    break
                counts[k][tuple(seq[i - k + 1:i + 1])] += 1
    return counts


def _kn_discounts(counts: Counter) -> Tuple[float, float, float]:
    """Modified-KN discounts D1, D2, D3+ from counts-of-counts
    (Chen & Goodman 1998 eq. 26)."""
    n = Counter()
    for c in counts.values():
        if c <= 4:
            n[c] += 1
    n1, n2, n3, n4 = (max(n[i], 1) for i in (1, 2, 3, 4))
    y = n1 / (n1 + 2.0 * n2)
    d1 = max(1.0 - 2.0 * y * n2 / n1, 0.1)
    d2 = max(2.0 - 3.0 * y * n3 / n2, 0.1)
    d3 = max(3.0 - 4.0 * y * n4 / n3, 0.1)
    return d1, d2, d3


def train_ngram_lm(sentences: Iterable[Sequence[str]],
                   order: int = 3,
                   vocab: Optional[set] = None,
                   min_counts: Optional[Sequence[int]] = None,
                   prune_threshold: float = 0.0) -> NgramLm:
    """Interpolated modified Kneser-Ney estimation.

    min_counts[k-1]: discard k-grams rarer than this before estimation
    (count cutoffs); prune_threshold: SRILM-style relative-entropy
    pruning of orders >= 2 after estimation.
    """
    sentences = list(sentences)
    if vocab is not None:
        vocab = set(vocab)
        vocab |= {BOS, EOS, _unk_symbol(vocab)}
    raw = _count_ngrams(sentences, order, vocab)
    _apply_min_counts(raw, order, min_counts)
    return estimate_from_counts(raw, order,
                                prune_threshold=prune_threshold)


def _apply_min_counts(raw, order: int,
                      min_counts: Optional[Sequence[int]]) -> None:
    """Per-order count cutoffs (never order 1), in place."""
    if not min_counts:
        return
    for k in range(2, order + 1):
        cutoff = min_counts[k - 1] if k - 1 < len(min_counts) else 1
        if cutoff > 1:
            raw[k] = Counter({g: c for g, c in raw[k].items()
                              if c >= cutoff})


def estimate_from_counts(raw, order: int,
                         prune_threshold: float = 0.0) -> "NgramLm":
    """Interpolated modified-KN estimation from raw (post-cutoff) counts
    — ``raw[k]`` is a Counter over k-gram tuples.  This is the
    interchange point with the native counter (native/src/ngram_count.cc
    via ``count_ngrams_file``)."""
    # KN continuation counts for orders < N (how many distinct left
    # contexts), raw counts for the highest order; grams starting with
    # <s> keep raw counts (nothing can precede <s>)
    counts = [Counter() for _ in range(order + 1)]
    counts[order] = raw[order]
    for k in range(order - 1, 0, -1):
        cont = Counter()
        for gram in raw[k + 1]:
            cont[gram[1:]] += 1
        for gram, c in raw[k].items():
            if gram[0] == BOS:
                cont[gram] = c
            elif gram not in cont:
                cont[gram] = c          # unseen as continuation: keep raw
        counts[k] = cont

    lm = NgramLm(order)
    uniform = None

    for k in range(1, order + 1):
        ck = counts[k]
        if not ck:
            continue
        d1, d2, d3 = _kn_discounts(ck)

        def discount(c):
            return d1 if c == 1 else d2 if c == 2 else d3

        # group by history; grams ending in <s> are never predicted —
        # they host bows but stay OUT of the distribution (else their
        # counts steal normalization mass from the real vocab)
        hist_total = Counter()
        hist_nj = defaultdict(lambda: [0, 0, 0])   # N1, N2, N3+
        for gram, c in ck.items():
            if gram[-1] == BOS:
                continue
            h = gram[:-1]
            hist_total[h] += c
            hist_nj[h][min(c, 3) - 1] += 1

        if k == 1:
            vocab_size = len(ck) - sum(
                1 for g in ck if g[-1] == BOS)
            uniform = 1.0 / vocab_size
        for gram, c in ck.items():
            if gram[-1] == BOS:
                lm.probs[k][gram] = -99.0   # <s> entry: bow host only
                continue
            h = gram[:-1]
            total = hist_total[h]
            nj = hist_nj[h]
            gamma = (d1 * nj[0] + d2 * nj[1] + d3 * nj[2]) / total
            p = max(c - discount(c), 0.0) / total
            if k == 1:
                p += gamma * uniform
            else:
                p += gamma * (10.0 ** lm.logprob(h[1:], gram[-1]))
            lm.probs[k][gram] = math.log10(max(p, 1e-99))
        # backoff weights on histories of length k (computed after the
        # k+1 probabilities exist) — defer; see _compute_bows
    _compute_bows(lm)

    if prune_threshold > 0.0:
        _prune(lm, prune_threshold)
        _compute_bows_after_prune(lm)
    return lm


def _compute_bows(lm: NgramLm) -> None:
    """bow(h) = (1 - sum_kept p(w|h)) / (1 - sum_kept p(w|h'))."""
    for k in range(1, lm.order):
        kept = defaultdict(list)
        for gram in lm.probs[k + 1]:
            kept[gram[:-1]].append(gram[-1])
        for h in lm.probs[k]:            # every k-gram can host a bow
            words = kept.get(h)
            if not words:
                continue
            num = 1.0
            den = 1.0
            for w in words:
                num -= 10.0 ** lm.probs[k + 1][h + (w,)]
                den -= 10.0 ** lm.logprob(h[1:], w)
            if num <= 1e-12 or den <= 1e-12:
                continue
            lm.bows[k][h] = math.log10(num / den)


def _prune(lm: NgramLm, threshold: float) -> None:
    """SRILM-style pruning: drop an n-gram when the (history-weighted)
    log-prob loss from rerouting it through the backoff is below the
    threshold.  p(h) is approximated by the chain of LM probabilities."""
    for k in range(lm.order, 1, -1):
        # never prune a gram that is the prefix (bow host) of a kept
        # higher-order gram — keeps the ARPA prefix-closed
        protected = {g[:-1] for g in lm.probs[k + 1]} \
            if k < lm.order else set()
        doomed = []
        for gram, logp in lm.probs[k].items():
            h, w = gram[:-1], gram[-1]
            if w in (BOS,) or gram in protected:
                continue
            # history marginal approximation: product along the chain
            ph = 1.0
            for i in range(len(h)):
                if i == 0 and h[0] == BOS:
                    # <s> carries the -99 placeholder unigram, which
                    # would doom EVERY sentence-initial history; its
                    # true marginal equals p(</s>) (each sentence has
                    # exactly one of each)
                    ph *= 10.0 ** lm.logprob((), EOS)
                else:
                    ph *= 10.0 ** lm.logprob(h[:i], h[i])
            p_here = 10.0 ** logp
            p_lower = 10.0 ** lm.logprob(h[1:], w)
            bow = 10.0 ** lm.bows[len(h)].get(h, 0.0)
            delta = ph * p_here * (logp * LOG10
                                   - math.log(max(bow * p_lower, 1e-99)))
            if delta < threshold:
                doomed.append(gram)
        for gram in doomed:
            del lm.probs[k][gram]
        # histories that lost all extensions keep their bow until the
        # final bow recomputation


def _compute_bows_after_prune(lm: NgramLm) -> None:
    for k in range(1, lm.order):
        lm.bows[k].clear()
    _compute_bows(lm)


def write_arpa(lm: NgramLm, out=sys.stdout) -> None:
    out.write("\\data\\\n")
    for k in range(1, lm.order + 1):
        out.write("ngram %d=%d\n" % (k, len(lm.probs[k])))
    out.write("\n")
    for k in range(1, lm.order + 1):
        out.write("\\%d-grams:\n" % k)
        for gram in sorted(lm.probs[k]):
            logp = max(lm.probs[k][gram], -99.0)
            line = "%.6f\t%s" % (logp, " ".join(gram))
            bow = lm.bows[k].get(gram) if k < lm.order else None
            if bow is not None:
                line += "\t%.6f" % bow
            out.write(line + "\n")
        out.write("\n")
    out.write("\\end\\\n")


def perplexity(lm: NgramLm, sentences: Iterable[Sequence[str]]) -> float:
    """10^(-avg log10 p) over all predicted tokens (incl. </s>)."""
    total_logp = 0.0
    tokens = 0
    for sent in sentences:
        total_logp += lm.sentence_logprob(sent)
        tokens += len(sent) + 1
    return 10.0 ** (-total_logp / max(tokens, 1))


def _native_counter_path() -> Optional[str]:
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "build", "native", "count-ngrams")
    if os.path.exists(path) and \
            os.environ.get("LSTM_CTC_TPU_NATIVE_COUNTS", "1") != "0":
        return path
    return None


def count_ngrams_file(path: str, order: int,
                      vocab_path: Optional[str] = None,
                      kaldi_text: bool = True,
                      min_counts: Optional[Sequence[int]] = None):
    """Count n-grams of a text file: the native C++ counter
    (native/src/ngram_count.cc) when ``_native.py`` has built it — same
    semantics as ``_count_ngrams``, parity-tested — else the Python path.  Returns the
    ``raw`` counts structure ``estimate_from_counts`` consumes."""
    binary = _native_counter_path()
    if binary is None or path == "-":
        vocab = None
        if vocab_path:
            with open(vocab_path, encoding="utf-8") as fh:
                vocab = {line.split()[0] for line in fh if line.split()}
            vocab |= {BOS, EOS, _unk_symbol(vocab)}
        raw = _count_ngrams(read_sentences(path, kaldi_text), order,
                            vocab)
        _apply_min_counts(raw, order, min_counts)
        return raw

    import subprocess
    cmd = [binary, "--order", str(order)]
    if kaldi_text:
        cmd.append("--kaldi-text")
    if vocab_path:
        cmd += ["--vocab", vocab_path]
        # match the wordlist's OOV convention (<UNK> in Kaldi dicts)
        with open(vocab_path, encoding="utf-8") as fh:
            vset = {line.split()[0] for line in fh if line.split()}
        cmd += ["--unk", _unk_symbol(vset)]
    if min_counts:
        cmd += ["--min-counts", ",".join(str(c) for c in min_counts)]
    if path.endswith(".gz"):
        # the binary reads plain text; decompress through a pipe,
        # streaming chunk-wise — LM corpora can be billions of tokens,
        # so neither the decompressed input nor a full-corpus buffer may
        # ever be resident.  A feeder thread copies gzip→stdin while the
        # main thread drains stdout (counts are vocab-sized, not
        # corpus-sized, so reading them fully is fine).
        import gzip
        import shutil
        import threading
        proc = subprocess.Popen(cmd + ["-"], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE)

        feed_error = []

        def _feed():
            try:
                with gzip.open(path, "rb") as fh:
                    shutil.copyfileobj(fh, proc.stdin, 1 << 20)
            except BaseException as exc:   # surfaced in the main thread
                feed_error.append(exc)
            finally:
                proc.stdin.close()

        feeder = threading.Thread(target=_feed, daemon=True)
        feeder.start()
        out = proc.stdout.read()
        feeder.join()
        proc.wait()
        if feed_error:
            # a corrupt/truncated .gz must not yield silently short
            # counts with exit status 0 (the binary just sees EOF)
            raise RuntimeError("count-ngrams: error decompressing %s: %s"
                               % (path, feed_error[0]))
    else:
        proc = subprocess.Popen(cmd + [path], stdout=subprocess.PIPE)
        out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("count-ngrams failed (rc=%d)" % proc.returncode)
    raw = [Counter() for _ in range(order + 1)]
    for line in out.decode("utf-8").splitlines():
        gram_s, _, count_s = line.rpartition("\t")
        gram = tuple(gram_s.split(" "))
        raw[len(gram)][gram] = int(count_s)
    return raw
