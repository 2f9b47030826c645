"""Streaming inference (``models/streaming.py``, ``nnet_forward
--streaming``) on the CPU.

The port's ``StreamingSession`` is held against the JAX package's session
on the same weights and raw frames, and against the port's own offline
forward, for chunks of 1, 5 and 32 model rows, with and without batch norm
(rtol = atol = 1e-4, as for the whole model's logits).  The session runs
the stack kernel's plain version with the carried states, and a stack that
is not uniform one layer at a time.  ``nnet_forward --streaming`` writes
the archive ``bin/nnet-forward.py --streaming`` writes.
"""

import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu import kaldi
from lstm_ctc_tpu.config import format_config
from lstm_ctc_tpu.data import RecordShardWriter
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.models.streaming import StreamingSession as JaxSession
from lstm_ctc_tpu.train.checkpoint import save_checkpoint as jax_save
from lstm_ctc_tpu_torch.bin import nnet_forward
from lstm_ctc_tpu_torch.host.data import splice_frames, subsample_frames
from lstm_ctc_tpu_torch.models import apply_model, init_model
from lstm_ctc_tpu_torch.models.streaming import StreamingSession
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(nnet_type="lstm", input_dim=6, left_context=1, right_context=1,
              subsample=2, num_layers=3, num_neurons=16, num_projects=8,
              num_targets=7, use_peepholes=True, dropout_rate=1.0,
              num_experts=0, seed=5)
TOL = dict(rtol=1e-4, atol=1e-4)


def model(config, seed=0):
    params, state = jax_init_model(jax.random.PRNGKey(seed), config)
    if config.get("use_bn"):
        rs = np.random.RandomState(7)
        for bn in list(state["bn"]) + [state["bn_in"]]:
            dim = bn["mean"].shape[0]
            bn["mean"] = jnp.asarray(rs.randn(dim) * 0.3, jnp.float32)
            bn["var"] = jnp.asarray(0.5 + rs.rand(dim), jnp.float32)
    return params, state


def port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def stream(session, raw, feed):
    chunks = [session.process(raw[i:i + feed])
              for i in range(0, len(raw), feed)]
    chunks.append(session.process(None, flush=True))
    return np.concatenate(chunks)


def offline(params, state, config, raw):
    feats = subsample_frames(splice_frames(
        raw, config["left_context"], config["right_context"]),
        config["subsample"])
    logits = apply_model(params, state, torch.from_numpy(feats[None]),
                         torch.tensor([feats.shape[0]], dtype=torch.int32),
                         config)[0]
    return logits[0].numpy()


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("chunk", [1, 5, 32])
def test_session_matches_jax_and_offline(chunk, use_bn):
    config = dict(CONFIG, use_bn=use_bn)
    jparams, jstate = model(config)
    raw = np.random.RandomState(1).randn(57, 6).astype(np.float32)
    want = stream(JaxSession(jparams, jstate, config, chunk_size=chunk),
                  raw, 7)
    params, state = port(jparams), port(jstate)
    got = stream(StreamingSession(params, state, config, chunk_size=chunk),
                 raw, 7)
    assert got.shape == want.shape == (28, 7)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, offline(params, state, config, raw),
                               **TOL)


@pytest.mark.parametrize("update", [
    {"nnet_type": "cudnnlstm", "num_projects": 0, "use_peepholes": False},
    {"num_layers": 1},                                    # one layer
    {"left_context": 0, "right_context": 0, "subsample": 0, "input_dim": 8,
     "use_bn": True},                                     # layer-0 residual
    {"num_experts": 3},
])
def test_other_models_stream(update):
    config = dict(CONFIG, **update)
    jparams, jstate = model(config, seed=2)
    raw = np.random.RandomState(2).randn(41, config["input_dim"]).astype(
        np.float32)
    want = stream(JaxSession(jparams, jstate, config, chunk_size=8), raw, 9)
    params, state = port(jparams), port(jstate)
    got = stream(StreamingSession(params, state, config, chunk_size=8), raw,
                 9)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, offline(params, state, config, raw),
                               **TOL)


def test_reset_serves_the_next_utterance():
    params, state = init_model(torch.Generator().manual_seed(0), CONFIG)
    rng = np.random.RandomState(3)
    first, second = (rng.randn(n, 6).astype(np.float32) for n in (30, 23))
    shared = StreamingSession(params, state, CONFIG, chunk_size=4)
    stream(shared, first, 5)
    shared.reset()
    again = stream(shared, second, 5)
    fresh = stream(StreamingSession(params, state, CONFIG, chunk_size=4),
                   second, 5)
    np.testing.assert_array_equal(again, fresh)


def test_session_rejects_blstm():
    config = dict(CONFIG, nnet_type="blstm")
    params, state = init_model(torch.Generator().manual_seed(0), config)
    with pytest.raises(ValueError, match="causal"):
        StreamingSession(params, state, config)


def _reference_forward():
    spec = importlib.util.spec_from_file_location(
        "reference_nnet_forward", os.path.join(REPO, "bin", "nnet-forward.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_streaming_cli_matches_reference(tmp_path):
    config = dict(CONFIG, use_bn=True)
    params, state = model(config, seed=4)
    nnet = str(tmp_path / "nnet.npz")
    jax_save(nnet, params, state)
    config_path = tmp_path / "nnet.config"
    config_path.write_text(format_config(config))
    rng = np.random.RandomState(4)
    scp = tmp_path / "feats.scp"
    with RecordShardWriter(str(tmp_path / "feats.rec")) as writer:
        for i in range(4):
            writer.write("utt%d" % i, rng.randn(rng.randint(20, 60),
                                                6).astype(np.float32))
        scp.write_text("".join(m.scp_line() for m in writer.metas))
    ref_ark, ark = str(tmp_path / "ref.ark"), str(tmp_path / "port.ark")
    _reference_forward().main(argparse.Namespace(
        tfrecords_scp=str(scp), nnet_config=str(config_path), nnet_in=nnet,
        nnet_output="ark:" + ref_ark, apply_softmax=True, apply_log=True,
        report_interval=0, class_prior=None, smooth_factor=1.0,
        batch_size=16, streaming=True, chunk_frames=6))
    written = nnet_forward.main([str(scp), str(config_path), nnet,
                                 "ark:" + ark, "--device", "cpu",
                                 "--streaming", "true", "--chunk-frames",
                                 "6"])
    assert written == 4
    got = dict(kaldi.SequentialBaseFloatMatrixReader("ark:" + ark))
    want = dict(kaldi.SequentialBaseFloatMatrixReader("ark:" + ref_ark))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
