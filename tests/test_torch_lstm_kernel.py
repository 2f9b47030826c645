"""The fused BLSTM layer wrapper (``ops/lstm_kernels``).

On the CPU the wrapper runs its plain version; it is held against the JAX
package's fused Pallas kernel in interpret mode (f32, rtol = atol = 1e-5).
The ``cuda`` tests hold kernel A against its plain version on the card;
they skip without a GPU.  JAX is imported by a fixture, so the ``cuda``
tests also run where JAX is not installed (pytest --noconftest).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels

FORGET_BIAS = 5.0


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import cells as jcells
    from lstm_ctc_tpu.ops.lstm_pallas import bilstm_dual_scan_fused
    return types.SimpleNamespace(jax=jax, jnp=jnp, cells=jcells,
                                 fused=bilstm_dual_scan_fused)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_case(seed, batch=3, time_steps=21, dim=6, units=16, proj=8,
                peepholes=True, reset=False):
    """Port parameters and numpy inputs from a seed."""
    gen = torch.Generator().manual_seed(seed)
    fw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
    bw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
    rng = np.random.RandomState(seed)
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


@pytest.mark.parametrize("seed,peep,proj,reset", [
    (0, True, 8, False), (1, False, 8, False), (2, True, None, False),
    (3, True, 8, True)])
def test_wrapper_cpu_matches_jax_fused_interpret(jref, seed, peep, proj,
                                                 reset):
    fw, bw, x, seq_len, reset_mask = random_case(seed, peepholes=peep,
                                                 proj=proj, reset=reset)
    jnp = jref.jnp
    jfw = {k: jnp.asarray(v.numpy()) for k, v in fw.items()}
    jbw = {k: jnp.asarray(v.numpy()) for k, v in bw.items()}
    if reset_mask is None:
        x_rev = jref.cells.reverse_sequence(jnp.asarray(x),
                                            jnp.asarray(seq_len))
    else:
        x_rev = jref.cells.reverse_segments(jnp.asarray(x),
                                            jnp.asarray(seq_len),
                                            jnp.asarray(reset_mask))
    ref = jref.fused(jfw, jbw, jnp.asarray(x), x_rev, jnp.asarray(seq_len),
                     FORGET_BIAS, time_block=8, store_dtype="float32",
                     interpret=True,
                     reset_mask=None if reset_mask is None
                     else jnp.asarray(reset_mask))
    before = lstm_kernels.lstm_layer_forward.launches
    got = lstm_kernels.bilstm_dual_scan_fused(
        fw, bw, torch.from_numpy(x), torch.from_numpy(np.array(x_rev)),
        torch.from_numpy(seq_len), FORGET_BIAS,
        reset_mask=None if reset_mask is None
        else torch.from_numpy(reset_mask))
    # the CPU path runs the plain version: no kernel launch is counted
    assert lstm_kernels.lstm_layer_forward.launches == before
    flat_got = [got[0], got[1], got[2][0][0], got[2][0][1], got[2][1][0],
                got[2][1][1]]
    flat_ref = [ref[0], ref[1], ref[2][0][0], ref[2][0][1], ref[2][1][0],
                ref[2][1][1]]
    for name, g, r in zip(("fw_out", "bw_out", "fw_c", "fw_h", "bw_c",
                           "bw_h"), flat_got, flat_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_wrapper_refuses_other_devices():
    fw, bw, x, seq_len, _ = random_case(4)
    gx, wh, proj, peep = cells.layer_inputs(fw, bw, torch.from_numpy(x),
                                            torch.from_numpy(x))
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_kernels.lstm_layer_forward(gx.to("meta"), torch.from_numpy(
            seq_len), None, wh, proj, peep, FORGET_BIAS)


def test_layer_inputs_bf16_rounds_operands():
    fw, bw, x, _, _ = random_case(5)
    xt = torch.from_numpy(x)
    gx32, wh32, proj32, peep32 = cells.layer_inputs(fw, bw, xt, xt)
    gx16, wh16, proj16, peep16 = cells.layer_inputs(fw, bw, xt, xt,
                                                    torch.bfloat16)
    assert gx16.dtype == torch.float32 and peep16.dtype == torch.float32
    assert wh16.dtype == torch.bfloat16 and proj16.dtype == torch.bfloat16
    assert torch.equal(wh16, wh32.to(torch.bfloat16))
    assert torch.equal(peep16, peep32)
    np.testing.assert_allclose(gx16.numpy(), gx32.numpy(), atol=5e-2)


@pytest.mark.parametrize("inference", [False, True])
def test_recurrent_weights_made_once_per_model(inference):
    """The stacked (and cast) weights are made on first use and reused
    until a weight changes in place or the parameters are dropped."""
    fw, bw, _, _, _ = random_case(8)
    with torch.inference_mode(inference):
        first = cells.recurrent_weights(fw, bw, torch.bfloat16)
        again = cells.recurrent_weights(fw, bw, torch.bfloat16)
        assert all(a is b for a, b in zip(first, again))
        f32 = cells.recurrent_weights(fw, bw, torch.float32)
        assert f32[0] is not first[0] and f32[0].dtype == torch.float32
    with torch.no_grad():
        fw["wh"].add_(1.0)
    with torch.inference_mode(inference):
        changed = cells.recurrent_weights(fw, bw, torch.float32)
    assert changed[0] is not f32[0]
    assert torch.equal(changed[0][0], fw["wh"])
    assert torch.equal(changed[2][1, 0], bw["w_i_diag"])


def test_derived_entries_go_with_their_sources():
    fw, bw, _, _, _ = random_case(9)
    before = len(cells._DERIVED)
    cells.recurrent_weights(fw, bw, torch.float32)
    assert len(cells._DERIVED) == before + 1
    del fw, bw
    assert len(cells._DERIVED) == before


def layer_args(fw, bw, x, seq_len, reset_mask, dtype=None, device="cpu"):
    """The wrapper's arguments for one layer, on ``device``."""
    xt = torch.from_numpy(x).to(device)
    seq = torch.from_numpy(seq_len).to(device)
    gx, wh, pj, peep = cells.layer_inputs(
        fw, bw, xt, cells.reverse_sequence(xt, seq), dtype)
    _, keep = cells.step_masks(
        seq, None if reset_mask is None else torch.from_numpy(reset_mask),
        x.shape[1], device)
    return gx, seq, keep, wh, pj, peep, FORGET_BIAS


@pytest.mark.parametrize("peep,proj,reset", [(True, 8, False),
                                             (False, None, True)])
def test_replay_steps_reproduces_plain_states(peep, proj, reset):
    """Each step replayed from the per-step states gives those states."""
    fw, bw, x, seq_len, reset_mask = random_case(10, peepholes=peep,
                                                 proj=proj, reset=reset)
    args = layer_args(fw, bw, x, seq_len, reset_mask)
    out, cfin, hfin, c_all, h_all = lstm_kernels.lstm_layer_forward(
        *args, states=True)
    assert torch.equal(cfin, c_all[-1]) and torch.equal(hfin, h_all[-1])
    assert torch.equal(out, cells.dual_recurrence(*args)[0])
    for name, got, want in zip(("out", "c_all", "h_all"),
                               cells.replay_steps(*args, c_all, h_all),
                               (out, c_all, h_all)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # a wrong state shows in the step after it
    bad = h_all.clone()
    bad[5, 0] += 0.1
    replayed = cells.replay_steps(*args, c_all, bad)[0]
    assert (replayed[6, 0] - out[6, 0]).abs().max() > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("proj,peep,reset", [
    (8, True, True), (None, True, True), (8, False, False),
    (None, False, False)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
def test_kernel_states_replay_on_gpu(cuda, dtype, tol, proj, peep, reset):
    """The kernel's per-step states, each step replayed by the plain
    version from the kernel's states of the step before (resets applied
    inside the step, with and without a projection and peepholes)."""
    fw, bw, x, seq_len, reset_mask = random_case(11, batch=6, time_steps=40,
                                                 proj=proj, peepholes=peep,
                                                 reset=reset)
    fw = {k: v.to(cuda) for k, v in fw.items()}
    bw = {k: v.to(cuda) for k, v in bw.items()}
    args = layer_args(fw, bw, x, seq_len, reset_mask, dtype, cuda)
    out, cfin, hfin, c_all, h_all = lstm_kernels.lstm_layer_forward(
        *args, states=True)
    assert torch.equal(cfin, c_all[-1]) and torch.equal(hfin, h_all[-1])
    for got, want in zip((out, c_all, h_all),
                         cells.replay_steps(*args, c_all, h_all)):
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,proj,reset,peep", [
    (torch.float32, 8, False, True), (torch.float32, 8, True, True),
    (torch.float32, None, False, True), (torch.bfloat16, 8, True, True),
    (torch.float32, None, True, False), (torch.float32, 8, True, False),
    (torch.bfloat16, None, True, True), (torch.bfloat16, 8, False, False),
    (torch.bfloat16, None, False, False)])
def test_kernel_matches_plain_on_gpu(cuda, dtype, proj, reset, peep):
    fw, bw, x, seq_len, reset_mask = random_case(6, batch=6, time_steps=40,
                                                 proj=proj, peepholes=peep,
                                                 reset=reset)
    fw = {k: v.to(cuda) for k, v in fw.items()}
    bw = {k: v.to(cuda) for k, v in bw.items()}
    xt = torch.from_numpy(x).to(cuda)
    seq = torch.from_numpy(seq_len).to(cuda)
    gx, wh, pj, peep = cells.layer_inputs(
        fw, bw, xt, cells.reverse_sequence(xt, seq), dtype)
    _, keep = cells.step_masks(
        seq, None if reset_mask is None else torch.from_numpy(reset_mask),
        x.shape[1], cuda)
    before = lstm_kernels.lstm_layer_forward.launches
    got = lstm_kernels.lstm_layer_forward(gx, seq, keep, wh, pj, peep,
                                          FORGET_BIAS)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, peep, FORGET_BIAS)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_layer_forward.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, r in zip(got, ref):
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("units,proj,time_steps", [
    (18, 8, 40), (18, None, 40), (16, 8, 1), (16, 8, 2), (16, None, 2),
    (16, None, 3)])
def test_kernel_odd_widths_and_short_sequences_on_gpu(cuda, units, proj,
                                                      time_steps):
    """A width whose gate rows are not 16-byte aligned (gx reaches the
    ring element by element) and sequences of 1-3 steps (hand-offs that
    are never armed), in float32 against the plain version."""
    fw, bw, x, seq_len, _ = random_case(12, batch=5, time_steps=time_steps,
                                        units=units, proj=proj)
    fw = {k: v.to(cuda) for k, v in fw.items()}
    bw = {k: v.to(cuda) for k, v in bw.items()}
    args = layer_args(fw, bw, x, seq_len, None, torch.float32, cuda)
    got = lstm_kernels.lstm_layer_forward(*args, states=True)
    ref = cells.dual_recurrence(*args, states=True)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err <= 1e-4


@pytest.mark.parametrize("units,out_dim,proj,cluster", [
    (16, 8, True, 8), (20, 20, False, 8), (320, 320, True, 8),
    (1024, 256, True, 16), (384, 384, True, 16), (36, 36, False, 16),
    (2048, 512, True, 16)],
    ids=["16-8-True", "20-20-False", "320-320-True", "1024-256-True-16",
         "384-384-True-16", "36-36-False-16", "2048-512-True-16"])
def test_cluster_slices_layout(units, out_dim, proj, cluster):
    """Block q of a cluster (8 or 16 blocks) gets units [q·US, (q+1)·US) of
    every gate and projection columns [q·PS, (q+1)·PS); depths padded to 16
    with zeros.  A block of K1 or K2 owns at most 128 units: 2048 with 16
    blocks, not with 8."""
    gen = torch.Generator().manual_seed(7)
    wh = torch.randn(2, out_dim, 4 * units, generator=gen)
    pj = torch.randn(2, units, out_dim, generator=gen) if proj else None
    if units > 1024:
        with pytest.raises(ValueError, match="at most 1024 units"):
            lstm_kernels._slices(wh, pj, 8)
    wh_sl, pj_sl = lstm_kernels._slices(wh, pj, cluster)
    us = wh_sl.shape[-1]
    assert us % 8 == 0 and us - 8 < -(-units // cluster) <= us
    assert wh_sl.shape == (2, cluster, -(-out_dim // 16) * 16, 4, us)
    assert not wh_sl[:, :, out_dim:].any()
    gates = wh.view(2, out_dim, 4, units)
    for q in range(cluster):
        for j in range(us):
            u = q * us + j
            col = wh_sl[:, q, :out_dim, :, j]
            assert torch.equal(col, gates[..., u]) if u < units \
                else not col.any()
    if not proj:
        assert pj_sl is None
        return
    ps = pj_sl.shape[-1]
    assert ps % 16 == 0 and ps - 16 < -(-out_dim // cluster) <= ps
    assert pj_sl.shape == (2, cluster, -(-units // 16) * 16, ps)
    assert not pj_sl[:, :, units:].any()
    for q in range(cluster):
        for j in range(ps):
            p = q * ps + j
            col = pj_sl[:, q, :units, j]
            assert torch.equal(col, pj[..., p]) if p < out_dim \
                else not col.any()
