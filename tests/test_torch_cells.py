"""The port's plain BLSTM recurrence against the JAX dual scan (CPU, f32).

Same weights (the JAX init, passed through numpy) and the same inputs
(numpy, from a seed) go through ``lstm_ctc_tpu.models.cells`` and
``lstm_ctc_tpu_torch.models.cells``.  Tolerance rtol = atol = 1e-5, as the
JAX package's own fused-vs-scan tests use: the arithmetic is the same, the
sums are ordered differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_ctc_tpu.models import cells as jcells
from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(seed, batch=3, time_steps=23, dim=6, units=16, proj=8,
              peepholes=True, reset=False):
    rng = np.random.RandomState(seed)
    fw = jcells.init_lstm_cell(jax.random.PRNGKey(seed), dim, units,
                               num_proj=proj, use_peepholes=peepholes)
    bw = jcells.init_lstm_cell(jax.random.PRNGKey(seed + 100), dim, units,
                               num_proj=proj, use_peepholes=peepholes)
    x = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq_len = rng.randint(time_steps // 2, time_steps + 1,
                          batch).astype(np.int32)
    seq_len[0] = time_steps
    reset_mask = None
    if reset:
        reset_mask = np.zeros((batch, time_steps), np.float32)
        reset_mask[:, 0] = 1.0
        for b in range(batch):
            reset_mask[b, rng.randint(1, seq_len[b], 2)] = 1.0
    return fw, bw, x, seq_len, reset_mask


def run_both(fw, bw, x, seq_len, reset_mask):
    jrev = (jcells.reverse_sequence if reset_mask is None else
            lambda v, s: jcells.reverse_segments(v, s, reset_mask))
    x_rev = jrev(jnp.asarray(x), jnp.asarray(seq_len))
    ref = jcells.bilstm_dual_scan(fw, bw, jnp.asarray(x), x_rev,
                                  jnp.asarray(seq_len), FORGET_BIAS,
                                  reset_mask=reset_mask)
    tfw = params_from_numpy(jax.tree.map(np.asarray, fw))
    tbw = params_from_numpy(jax.tree.map(np.asarray, bw))
    got = cells.bilstm_dual_scan(
        tfw, tbw, torch.from_numpy(x), torch.from_numpy(np.array(x_rev)),
        torch.from_numpy(seq_len), FORGET_BIAS,
        reset_mask=None if reset_mask is None else torch.from_numpy(
            reset_mask))
    return got, ref


def assert_same(got, ref):
    pairs = [(got[0], ref[0], "fw_out"), (got[1], ref[1], "bw_out"),
             (got[2][0][0], ref[2][0][0], "fw_c"),
             (got[2][0][1], ref[2][0][1], "fw_h"),
             (got[2][1][0], ref[2][1][0], "bw_c"),
             (got[2][1][1], ref[2][1][1], "bw_h")]
    for g, r, name in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("seed,peep,proj", [(0, True, 8), (1, False, 8),
                                            (2, True, None),
                                            (3, False, None)])
def test_dual_scan_matches_jax(seed, peep, proj):
    fw, bw, x, seq_len, _ = make_case(seed, peepholes=peep, proj=proj)
    assert_same(*run_both(fw, bw, x, seq_len, None))


def test_dual_scan_with_reset_mask_matches_jax():
    fw, bw, x, seq_len, reset = make_case(4, reset=True)
    assert_same(*run_both(fw, bw, x, seq_len, reset))


def test_outputs_zero_past_length():
    fw, bw, x, seq_len, _ = make_case(5)
    got, _ = run_both(fw, bw, x, seq_len, None)
    for b, n in enumerate(seq_len):
        assert not got[0][b, n:].any() and not got[1][b, n:].any()


def test_reverse_sequence_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(4, 11, 3).astype(np.float32)
    seq_len = np.array([11, 0, 5, 8], np.int32)
    ref = jcells.reverse_sequence(jnp.asarray(x), jnp.asarray(seq_len))
    got = cells.reverse_sequence(torch.from_numpy(x),
                                 torch.from_numpy(seq_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reverse_segments_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 12, 2).astype(np.float32)
    seq_len = np.array([12, 9, 4], np.int32)
    reset = np.zeros((3, 12), np.float32)
    reset[:, 0] = 1.0
    reset[0, [3, 7]] = 1.0
    reset[1, 5] = 1.0
    ref = jcells.reverse_segments(jnp.asarray(x), jnp.asarray(seq_len),
                                  jnp.asarray(reset))
    got = cells.reverse_segments(torch.from_numpy(x),
                                 torch.from_numpy(seq_len),
                                 torch.from_numpy(reset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_init_lstm_cell_layout():
    gen = torch.Generator().manual_seed(0)
    p = cells.init_lstm_cell(gen, 6, 16, 8, True)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wx": (6, 64), "wh": (8, 64), "bias": (64,), "w_i_diag": (16,),
        "w_f_diag": (16,), "w_o_diag": (16,), "proj": (16, 8)}
    limit = np.sqrt(6.0 / (6 + 8 + 64))
    assert float(p["wx"].abs().max()) <= limit
    assert float(p["bias"].abs().max()) == 0.0
    t = cells.truncated_normal(gen, (4000,), 0.5)
    assert float(t.abs().max()) <= 1.0
    assert abs(float(t.std()) - 0.5 * 0.8796) < 0.03
