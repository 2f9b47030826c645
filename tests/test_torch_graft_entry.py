"""The port's flagship examples and entry point (``lstm_ctc_tpu_torch/
graft_entry.py``) against ``__graft_entry__``: the example and packed
batches equal the reference's bit for bit, and ``entry()``'s forward at
full width gives JAX ``entry()``'s logits on the same weights (through the
checkpoint bridge) to rtol = atol = 1e-4 on the CPU."""

import jax
import numpy as np
import pytest

import __graft_entry__ as ref_entry
from lstm_ctc_tpu_torch import graft_entry
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy


def test_flagship_config_is_the_reference_s():
    assert graft_entry.FLAGSHIP_CONFIG == ref_entry.FLAGSHIP_CONFIG


@pytest.mark.parametrize("kwargs", [{}, {"batch": 5, "time_steps": 17,
                                         "rng_seed": 3}])
def test_example_batch_equals_reference(kwargs):
    got = graft_entry._example_batch(graft_entry.FLAGSHIP_CONFIG, **kwargs)
    ref = ref_entry._example_batch(ref_entry.FLAGSHIP_CONFIG, **kwargs)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("kwargs", [{}, {"num_rows": 4, "pack_factor": 3}])
def test_packed_batch_equals_reference(kwargs):
    got = graft_entry._packed_batch(graft_entry.FLAGSHIP_CONFIG, **kwargs)
    ref = ref_entry._packed_batch(ref_entry.FLAGSHIP_CONFIG, **kwargs)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key])


def test_entry_matches_jax_entry():
    fwd, (params, x, seq_len) = ref_entry.entry()
    ref = np.asarray(jax.jit(fwd)(params, x, seq_len))
    forward, (port_params, nnet_input, sequence_length) = \
        graft_entry.entry(device="cpu")
    assert nnet_input.shape == (4, 64, 120)
    np.testing.assert_array_equal(nnet_input.numpy(), np.asarray(x))
    np.testing.assert_array_equal(sequence_length.numpy(),
                                  np.asarray(seq_len))
    # the port's own random weights have the reference's tree and shapes
    bridged = params_from_numpy(jax.tree.map(np.asarray, params))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, bridged)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, port_params))
    got = forward(bridged, nnet_input, sequence_length)
    assert got.shape == ref.shape == (4, 64, 72)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_entry_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        graft_entry.entry()
