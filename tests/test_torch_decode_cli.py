"""``python -m lstm_ctc_tpu_torch.bin.nnet_decode`` on the CPU.

The port's decode CLI reads records written by ``RecordShardWriter`` and a
float32 checkpoint with a MoE head written by the JAX package; its
Int32Vector archive must equal ``bin/nnet-decode.py``'s on the same files,
greedy and at beam 4, with the native beam search (``libctc_beam.so``) and
with its Python specification (``LSTM_CTC_TPU_NATIVE_BEAM=0``), on both
sides.  ``host.decode.beam_search_decode_py`` must equal the JAX package's
copy on random log-probabilities, and the native search must equal it.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from lstm_ctc_tpu import kaldi
from lstm_ctc_tpu.config import format_config
from lstm_ctc_tpu.data import RecordShardWriter
from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.ops.decode import beam_search_decode_py as jax_beam_py
from lstm_ctc_tpu.train.checkpoint import save_checkpoint as jax_save
from lstm_ctc_tpu_torch.bin import nnet_decode
from lstm_ctc_tpu_torch.host import beam_native, decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(nnet_type="blstm", input_dim=5, left_context=1,
              right_context=1, subsample=3, num_layers=2, num_neurons=16,
              num_projects=8, num_targets=7, use_peepholes=True,
              dropout_rate=0.9, num_experts=3, moe_temp=10.0, seed=11)
# (beam width, native beam search)
VARIANTS = [(1, True), (4, True), (4, False)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Records, nnet.config, a JAX-written checkpoint, and the archives of
    ``bin/nnet-decode.py`` for each variant (its runs started together)."""
    work = tmp_path_factory.mktemp("decode")
    rng = np.random.RandomState(3)
    scp = work / "feats.scp"
    with RecordShardWriter(str(work / "feats.rec")) as writer:
        for i in range(9):
            writer.write("utt%d" % i, rng.randn(rng.randint(20, 90),
                                                5).astype(np.float32))
        scp.write_text("".join(m.scp_line() for m in writer.metas))
    config = work / "nnet.config"
    config.write_text(format_config(CONFIG))
    params, state = jax_init_model(jax.random.PRNGKey(8), CONFIG)
    nnet = work / "nnet.npz"
    jax_save(str(nnet), params, state)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)   # one CPU device, as a user runs it
    procs = {}
    for beam, native in VARIANTS:
        ark = work / ("bin_%d_%d.ark" % (beam, native))
        procs[beam, native] = (ark, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "bin", "nnet-decode.py"),
             str(scp), str(config), str(nnet), "ark:%s" % ark,
             "--beam-width", str(beam), "--batch-size", "4"],
            env=dict(env, LSTM_CTC_TPU_NATIVE_BEAM="1" if native else "0"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO))
    ref = {}
    for key, (ark, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err.decode()[-3000:]
        ref[key] = read_archive(ark)
    return dict(work=work, scp=str(scp), config=str(config), nnet=str(nnet),
                ref=ref)


def read_archive(path):
    return {k: [int(v) for v in vec] for k, vec in
            kaldi.SequentialInt32VectorReader("ark:%s" % path)}


@pytest.mark.parametrize("beam,native", VARIANTS,
                         ids=["greedy", "beam4-native", "beam4-python"])
def test_decode_matches_bin(corpus, monkeypatch, beam, native):
    monkeypatch.setenv("LSTM_CTC_TPU_NATIVE_BEAM", "1" if native else "0")
    beam_native._library.cache_clear()
    ark = corpus["work"] / ("port_%d_%d.ark" % (beam, native))
    try:
        n = nnet_decode.main([corpus["scp"], corpus["config"],
                              corpus["nnet"], "ark:%s" % ark,
                              "--beam-width", str(beam), "--batch-size", "4",
                              "--device", "cpu"])
        assert beam_native.available() is native
    finally:
        beam_native._library.cache_clear()
    got = read_archive(ark)
    assert n == 9 and sorted(got) == ["utt%d" % i for i in range(9)]
    assert got == corpus["ref"][beam, native]
    assert any(got.values())   # some utterance decodes to labels
    assert open(ark, "rb").read() == open(
        corpus["work"] / ("bin_%d_%d.ark" % (beam, native)), "rb").read()


@pytest.mark.parametrize("seed,frames,classes,beam", [
    (0, 30, 6, 4), (1, 50, 12, 8), (2, 1, 4, 2), (3, 40, 5, 1)])
def test_beam_search_py_matches_jax_copy(seed, frames, classes, beam):
    """The port's beam search (its Python specification and the native
    library) equals the JAX package's, top 3 paths."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(frames, classes).astype(np.float32) * 3
    lp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    want = jax_beam_py(lp, beam_width=beam, top_paths=3)
    assert decode.beam_search_decode_py(lp, beam_width=beam,
                                        top_paths=3) == want
    assert beam_native.beam_search_decode_native(lp, beam_width=beam,
                                                 top_paths=3) == want


def test_decode_cuda_without_gpu_raises(corpus):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnet_decode.main([corpus["scp"], corpus["config"], corpus["nnet"],
                          "ark:/dev/null"])
