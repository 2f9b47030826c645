"""``python -m lstm_ctc_tpu_torch.bin.nnet_forward`` on the CPU.

The port's forward CLI reads records written by ``RecordShardWriter`` and a
checkpoint written by the JAX package; its archive must equal JAX
``apply_model`` -> softmax -> log on the same batches (tolerance 1e-4, as
for the whole model's logits).  A subprocess that blocks ``jax``, ``optax``
and ``lstm_ctc_tpu`` proves the port never imports them.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu import kaldi
from lstm_ctc_tpu.cli import build_batcher as jax_build_batcher
from lstm_ctc_tpu.config import format_config
from lstm_ctc_tpu.data import RecordShardWriter, iterate_batches
from lstm_ctc_tpu.models import apply_model as jax_apply_model
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.train.checkpoint import save_checkpoint as jax_save
from lstm_ctc_tpu.train.class_prior import get_class_prior, subtract_log_prior
from lstm_ctc_tpu_torch.bin import nnet_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(nnet_type="blstm", input_dim=5, left_context=1,
              right_context=1, subsample=3, num_layers=2, num_neurons=16,
              num_projects=8, num_targets=7, use_peepholes=True,
              dropout_rate=0.9, num_experts=3, moe_temp=10.0, seed=11)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Records, nnet.config and a JAX-written checkpoint."""
    work = tmp_path_factory.mktemp("forward")
    rng = np.random.RandomState(0)
    scp = work / "feats.scp"
    with RecordShardWriter(str(work / "feats.rec")) as writer:
        for i in range(7):
            writer.write("utt%d" % i, rng.randn(rng.randint(20, 80),
                                                5).astype(np.float32))
        scp.write_text("".join(m.scp_line() for m in writer.metas))
    config = work / "nnet.config"
    config.write_text(format_config(CONFIG))
    params, state = jax_init_model(jax.random.PRNGKey(4), CONFIG)
    nnet = work / "nnet.npz"
    jax_save(str(nnet), params, state)
    counts = work / "counts"
    counts.write_text("[ 50 10 0 20 5 7 9 ]\n")
    return dict(work=work, scp=str(scp), config=str(config), nnet=str(nnet),
                params=params, state=state, counts=str(counts))


def jax_reference(corpus, batch_size, class_prior=None):
    batcher = jax_build_batcher(corpus["scp"], CONFIG, batch_size,
                                need_labels=False)
    out = {}
    for batch in iterate_batches(batcher, shuffle=False):
        logits, _, _, _ = jax_apply_model(
            corpus["params"], corpus["state"], jnp.asarray(batch.nnet_input),
            jnp.asarray(batch.sequence_length), CONFIG, train=False)
        post = np.log(np.asarray(jax.nn.softmax(logits)))
        if class_prior is not None:
            post = subtract_log_prior(post, class_prior)
        for row, key in enumerate(batch.keys):
            out[key] = post[row, :int(batch.sequence_length[row])]
    return out


def read_archive(path):
    return {k: v for k, v in
            kaldi.SequentialBaseFloatMatrixReader("ark:" + path)}


@pytest.mark.parametrize("with_prior", [False, True])
def test_forward_matches_jax(corpus, with_prior):
    ark = str(corpus["work"] / ("post_%d.ark" % with_prior))
    argv = [corpus["scp"], corpus["config"], corpus["nnet"], "ark:" + ark,
            "--device", "cpu", "--batch-size", "4"]
    prior = None
    if with_prior:
        argv += ["--class-prior", corpus["counts"]]
        prior = get_class_prior(corpus["counts"])
    assert nnet_forward.main(argv) == 7
    got = read_archive(ark)
    ref = jax_reference(corpus, 4, prior)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    if not with_prior:
        for mat in got.values():
            np.testing.assert_allclose(np.log(np.exp(mat).sum(1)), 0.0,
                                       atol=1e-5)


def test_port_runs_without_jax(corpus):
    ark = str(corpus["work"] / "post_nojax.ark")
    script = (
        "import sys\n"
        "for name in ('jax', 'optax', 'lstm_ctc_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from lstm_ctc_tpu_torch.bin import nnet_forward\n"
        "n = nnet_forward.main(sys.argv[1:])\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                               'lstm_ctc_tpu')]\n"
        "assert n == 7 and not bad, (n, bad)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", script, corpus["scp"], corpus["config"],
         corpus["nnet"], "ark:" + ark, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"
    assert sorted(read_archive(ark)) == ["utt%d" % i for i in range(7)]


def test_cuda_without_gpu_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnet_forward.main([corpus["scp"], corpus["config"], corpus["nnet"],
                           "ark:/dev/null"])


def test_streaming_rejects_blstm(corpus):
    """Only causal models stream; the reference raises the same error."""
    with pytest.raises(ValueError, match="causal model"):
        nnet_forward.main([corpus["scp"], corpus["config"], corpus["nnet"],
                           "ark:/dev/null", "--device", "cpu",
                           "--streaming", "true"])
