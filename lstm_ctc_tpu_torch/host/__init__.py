"""JAX-free host modules of the reference package, reached without its
package ``__init__``.

``import lstm_ctc_tpu.<anything>`` first runs ``lstm_ctc_tpu/__init__.py``,
which imports the training graph, the models and the ops, and through them
jax and optax.  The GPU machine has no JAX, so the port cannot import the
reference package by its own name.  This module is a package whose
``__path__`` is the reference package's directory: ``host.kaldi`` loads
``lstm_ctc_tpu/kaldi/__init__.py`` under the name
``lstm_ctc_tpu_torch.host.kaldi``, and relative imports inside it resolve
under ``host`` as well, so ``lstm_ctc_tpu/__init__.py`` never runs.

Only these may be imported through it; each uses numpy and relative
imports alone:

* ``host.kaldi``              Kaldi archive/scp readers and writers
* ``host.data``               record shards, splice/subsample, BucketedBatcher
* ``host.config``             ``nnet.config`` parse/format
* ``host.logging_util``       the ``INFO:tensorflow:`` stderr contract
* ``host.train.class_prior``  class prior for pseudo-likelihoods

Everything else in the reference package imports jax: ``host.models``,
``host.ops`` (its ``__init__`` imports ``ctc``), ``host.train.graph``,
``host.train.loop``, ``host.train.checkpoint``, ``host.parallel`` and
``host.cli``.  Their counterparts live in this package.
"""

import os

__path__ = [os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "lstm_ctc_tpu")]
