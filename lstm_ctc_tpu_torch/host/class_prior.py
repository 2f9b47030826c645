"""Class prior for converting posteriors to pseudo-likelihoods.

Reads a Kaldi ``analyze-counts`` label-count vector (text ``[ c0 c1 ... ]``),
normalizes to a log-prior, floors tiny probabilities, and rotates the blank
count from index 0 to the last index to match the network's label order
(blank = last output; labels were shifted by -1 at data prep, reference
egs/wsj/run_wsj_phn.sh:129-139).  Mirrors reference nnet/class_prior.py:30-47.
"""

from __future__ import annotations

import numpy as np

PRIOR_CUTOFF = 1e-10
LOG_ZERO = -1e10


def read_label_counts(path: str) -> np.ndarray:
    with open(path) as fh:
        for line in fh:
            body = line.strip().lstrip("[").rstrip("]").strip()
            if not body:
                continue
            return np.asarray([float(tok) for tok in body.split()],
                              dtype=np.float64)
    raise ValueError("no counts found in %s" % path)


def get_class_prior(label_counts_path: str) -> np.ndarray:
    counts = read_label_counts(label_counts_path)
    prior = counts / counts.sum()
    with np.errstate(divide="ignore"):
        log_prior = np.log(prior)
    log_prior[prior < PRIOR_CUTOFF] = LOG_ZERO
    # analyze-counts orders blank first; the network puts blank last.
    log_prior = np.concatenate([log_prior[1:], log_prior[:1]])
    return log_prior.astype(np.float32)


def subtract_log_prior(log_post: np.ndarray,
                       log_prior: np.ndarray) -> np.ndarray:
    """Pseudo-likelihood for WFST decoding: ``log_post − log_prior``,
    with zero-count classes SUPPRESSED.

    The reference floors the log-prior of classes absent from the
    training labels to −1e10 (reference nnet/class_prior.py:36-38) and
    subtracts it from the log-posterior (reference bin/nnet-forward.py:
    87-91) — which yields a **+1e10** score: a class that never occurred
    becomes infinitely attractive, and the WFST decoder finds no sane
    path.  The intent (Kaldi nnet1 ``PdfPrior``) is the opposite: a
    never-seen class must never be hypothesized.  This is one of the
    reference's latent bugs we implement the intended behavior for
    instead of replicating (it never fires on the full corpora, where
    every unit occurs, but does on small/partial label sets).
    """
    out = log_post - log_prior
    out[..., log_prior <= LOG_ZERO] = LOG_ZERO
    return out
