"""Checkpoint bridge between the JAX package and the PyTorch port.

A checkpoint written by either package must load in the other: same
``.npz`` layout (``params/``, ``state/``, ``extra/``), same '/'-joined tree
paths, identical arrays after a JAX -> torch -> .npz -> JAX round trip.
"""

import jax
import numpy as np
import pytest
import torch

from lstm_ctc_tpu.models import init_model as jax_init_model
from lstm_ctc_tpu.train import checkpoint as jax_ckpt
from lstm_ctc_tpu_torch.models import init_model
from lstm_ctc_tpu_torch.train.checkpoint import (
    flatten_tree,
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
    save_checkpoint,
)

CONFIG = dict(nnet_type="blstm", input_dim=4, left_context=1,
              right_context=1, num_layers=2, num_neurons=16, num_projects=8,
              num_targets=7, use_peepholes=True, num_experts=3, moe_temp=10.0)


def port_template(config):
    return init_model(torch.Generator().manual_seed(0), config)


@pytest.mark.parametrize("num_experts,num_projects", [(3, 8), (0, 8),
                                                      (3, 0)])
def test_jax_checkpoint_loads_into_port(tmp_path, num_experts, num_projects):
    config = dict(CONFIG, num_experts=num_experts, num_projects=num_projects)
    jparams, jstate = jax_init_model(jax.random.PRNGKey(1), config)
    path = str(tmp_path / "nnet.npz")
    jax_ckpt.save_checkpoint(path, jparams, jstate, extra={"epoch": 2})
    params, state, extra = load_checkpoint(path, *port_template(config))
    want = jax_ckpt.flatten_tree(jparams)
    got = flatten_tree(params)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert state == {}
    assert int(extra["epoch"]) == 2


def test_round_trip_jax_torch_npz_jax(tmp_path):
    jparams, _ = jax_init_model(jax.random.PRNGKey(2), CONFIG)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert isinstance(params["fwd"][1]["wh"], torch.Tensor)
    path = str(tmp_path / "nnet.npz")
    save_checkpoint(path, params, extra={"epoch": 5})
    back, _, extra = jax_ckpt.load_checkpoint(path, jparams)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams),
                         jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax_ckpt._path_str(p))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(extra["epoch"]) == 5
    flat = flatten_tree(params_to_numpy(params))
    assert flat.keys() == jax_ckpt.flatten_tree(jparams).keys()


def test_port_init_matches_jax_tree(tmp_path):
    """The port's init builds the JAX tree: same paths, shapes, dtypes."""
    jflat = jax_ckpt.flatten_tree(jax_init_model(jax.random.PRNGKey(0),
                                                 CONFIG)[0])
    flat = flatten_tree(port_template(CONFIG)[0])
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == \
        {k: (v.shape, v.dtype) for k, v in jflat.items()}


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "nnet.npz")
    save_checkpoint(path, port_template(CONFIG)[0])
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, port_template(dict(CONFIG,
                                                 num_neurons=12))[0])


@pytest.mark.parametrize("saved,loaded,message", [
    (dict(num_experts=3), dict(num_experts=0), "unexpected parameters"),
    (dict(num_layers=1), dict(num_layers=2), "missing parameter"),
])
def test_key_mismatch_raises(tmp_path, saved, loaded, message):
    path = str(tmp_path / "nnet.npz")
    save_checkpoint(path, port_template(dict(CONFIG, **saved))[0])
    with pytest.raises(KeyError, match=message):
        load_checkpoint(path, port_template(dict(CONFIG, **loaded))[0])


def test_wide_head_checkpoint_bridges_both_ways(tmp_path):
    """A MoE head of 256 targets an expert (K4-K6 past 128): a JAX
    checkpoint loads into the port array for array, and the port's save of
    it loads back into JAX unchanged."""
    config = dict(CONFIG, num_targets=256)
    jparams, jstate = jax_init_model(jax.random.PRNGKey(3), config)
    path = str(tmp_path / "nnet.npz")
    jax_ckpt.save_checkpoint(path, jparams, jstate, extra={"epoch": 1})
    params, _, _ = load_checkpoint(path, *port_template(config))
    want = jax_ckpt.flatten_tree(jparams)
    got = flatten_tree(params)
    assert sorted(got) == sorted(want)
    assert [v.shape for k, v in got.items() if k.endswith("w_expert")] == [
        (2 * 8, 3 * 256)]  # both directions of the last projection
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    back_path = str(tmp_path / "port.npz")
    save_checkpoint(back_path, params)
    back, _, _ = jax_ckpt.load_checkpoint(back_path, jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
