"""Host-side modules of the port: the port's own copies of the numpy-only
modules of the reference package, names kept so a reader finds the
counterpart.  They use numpy and relative imports alone; the port imports
nothing of ``lstm_ctc_tpu``.

* ``host.config``        ``lstm_ctc_tpu/config.py``: ``nnet.config`` parse/format
* ``host.logging_util``  ``lstm_ctc_tpu/logging_util.py``: the
  ``INFO:tensorflow:`` stderr contract
* ``host.class_prior``   ``lstm_ctc_tpu/train/class_prior.py``: class prior
  for pseudo-likelihoods
* ``host.data``          ``lstm_ctc_tpu/data/{records,pipeline}.py``: record
  shards, splice/subsample, ``BucketedBatcher``
* ``host.kaldi``         ``lstm_ctc_tpu/kaldi/{binio,specifiers,streams,table}.py``:
  Kaldi archive/scp readers and writers
* ``host.decode``        the numpy part of ``lstm_ctc_tpu/ops/decode.py``:
  greedy CTC decoding and edit distance (``cv_eval``)
"""
