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
  Kaldi archive/scp readers and writers; ``kaldi/nnet1.py`` (nnet1 model
  reader), ``kaldi/nnet_example.py`` (nnet3 example reader) and
  ``kaldi/randomizer.py`` (frame randomizers), exported as the reference
  exports them
* ``host.decode``        ``lstm_ctc_tpu/ops/decode.py``: greedy and beam CTC
  decoding, edit distance (``cv_eval``)
* ``host.beam_native``   ``lstm_ctc_tpu/ops/beam_native.py``: the native beam
  search (``libctc_beam.so`` of ``lstm_ctc_tpu_torch/_native.py``)
* ``host.featbin``       ``lstm_ctc_tpu/featbin.py``: Kaldi-style flags,
  column ranges, WAV reading, for the data tools
* ``host.data.features`` ``lstm_ctc_tpu/data/features.py``: fbank, MFCC,
  CMVN, deltas
* ``host.lm``            ``lstm_ctc_tpu/lm/``: n-gram estimation, ARPA
* ``host.wfst``          ``lstm_ctc_tpu/wfst/``: the CTC token FST
* ``host.nbest``         ``lstm_ctc_tpu/ops/nbest.py``: n-best targets and
  framewise CTC paths
"""
