"""The port's own host modules (``lstm_ctc_tpu_torch/host``).

The port imports nothing of the JAX package: a fresh interpreter that
imports every module of ``lstm_ctc_tpu_torch`` holds no module loaded from
a file under ``lstm_ctc_tpu/``, and no ``jax``.  The port's copy of the
batcher yields the JAX package's batches, packed and unpacked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lstm_ctc_tpu.data import BucketedBatcher as JaxBatcher
from lstm_ctc_tpu.data import iterate_batches as jax_iterate_batches
from lstm_ctc_tpu.data import scan_label_lengths as jax_scan_label_lengths
from lstm_ctc_tpu.data import scan_scp as jax_scan_scp
from lstm_ctc_tpu_torch.host.data import (BucketedBatcher, RecordShardWriter,
                                          iterate_batches, scan_label_lengths,
                                          scan_scp)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WALK = r"""
import json, os, pkgutil, sys
import lstm_ctc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    lstm_ctc_tpu_torch.__path__, "lstm_ctc_tpu_torch.")]
for name in names:
    __import__(name)
ref = os.path.join(sys.argv[1], "lstm_ctc_tpu") + os.sep
bad = sorted(n for n, m in sys.modules.items()
             if (getattr(m, "__file__", None) or "").startswith(ref))
print(json.dumps({"imported": names, "reference_files": bad,
                  "jax": "jax" in sys.modules}))
"""


def test_port_loads_no_reference_module_and_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", WALK, REPO], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "lstm_ctc_tpu_torch.host.data.pipeline" in result["imported"]
    assert "lstm_ctc_tpu_torch.bin.nnet_train" in result["imported"]
    for name in ("recipe_python", "_native", "bin.nnet_decode",
                 "bin.train_lm", "host.lm.ngram", "host.wfst.ctc_token_fst",
                 "host.featbin", "host.data.features", "host.beam_native"):
        assert "lstm_ctc_tpu_torch." + name in result["imported"]
    assert result["reference_files"] == []
    assert result["jax"] is False


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    work = tmp_path_factory.mktemp("host")
    rng = np.random.RandomState(0)
    scp = str(work / "feats.scp")
    with RecordShardWriter(str(work / "feats.rec")) as writer:
        for i in range(23):
            labels = rng.randint(0, 9, rng.randint(1, 12)).astype(np.int32)
            writer.write("utt%02d" % i, rng.randn(rng.randint(20, 200),
                                                  5).astype(np.float32),
                         labels)
        with open(scp, "w") as fh:
            fh.write("".join(m.scp_line() for m in writer.metas))
    return scp


@pytest.mark.parametrize("pack_factor,shuffle", [(1, False), (1, True),
                                                 (3, False), (3, True)])
def test_batcher_copy_matches_reference(corpus, pack_factor, shuffle):
    def batches(make, scan, scan_labels, iterate):
        metas = scan(corpus)
        batcher = make(metas, batch_size=4, left_context=1, right_context=1,
                       subsample=3, label_lengths=scan_labels(metas),
                       pack_factor=pack_factor)
        return list(iterate(batcher, shuffle=shuffle, seed=5))

    got = batches(BucketedBatcher, scan_scp, scan_label_lengths,
                  iterate_batches)
    want = batches(JaxBatcher, jax_scan_scp, jax_scan_label_lengths,
                   jax_iterate_batches)
    assert len(got) == len(want) > 1
    fields = ("nnet_input", "sequence_length", "nnet_target",
              "target_length", "reset_mask", "utt_time_index",
              "utt_sequence_length")
    for g, w in zip(got, want):
        assert g.keys == w.keys
        for name in fields:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)
