"""The BLSTM layer backward (``cells.dual_recurrence_backward``, kernel K2).

On the CPU the autograd layer (``lstm_kernels.bilstm_dual_scan_train``)
runs the plain forward and the plain backward.  Its gradients (every
parameter, and both inputs) are held against ``jax.vjp`` of the JAX
package's fused layer in interpret mode with store f32, and of its scan
``cells.bilstm_dual_scan`` (rtol = atol = 1e-5: float32 on both sides).
The ``cuda`` tests hold K2 against its plain version on the card:
max|diff| / max|plain| <= 1e-4 per output in float32, and in bfloat16 each
step replayed from the kernel's own carries within 1e-3.  JAX is imported
by a fixture, so the ``cuda`` tests also run where JAX is not installed
(pytest --noconftest).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)


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


def random_case(seed, batch=3, time_steps=13, dim=6, units=16, proj=8,
                peepholes=True, reset=False):
    """Port parameters, numpy inputs and output cotangents from a seed."""
    gen = torch.Generator().manual_seed(seed)
    fw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
    bw = cells.init_lstm_cell(gen, dim, units, proj, peepholes)
    rng = np.random.RandomState(seed)
    out_dim = proj or units
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
    cots = [rng.randn(batch, time_steps, out_dim).astype(np.float32)
            for _ in range(2)]
    cots += [rng.randn(batch, n).astype(np.float32)
             for n in (units, out_dim, units, out_dim)]
    return fw, bw, x, seq_len, reset_mask, cots


def jax_vjp(jref, fn, fw, bw, x, seq_len, reset_mask, cots):
    """Gradients (fw params, bw params, x, x_rev) of the JAX layer ``fn``
    under the given output cotangents."""
    jnp = jref.jnp
    jfw = {k: jnp.asarray(v.numpy()) for k, v in fw.items()}
    jbw = {k: jnp.asarray(v.numpy()) for k, v in bw.items()}
    seq = jnp.asarray(seq_len)
    reset = None if reset_mask is None else jnp.asarray(reset_mask)
    x_rev = jref.cells.reverse_sequence(jnp.asarray(x), seq) \
        if reset is None else \
        jref.cells.reverse_segments(jnp.asarray(x), seq, reset)

    def layer(a, b, xx, xr):
        return fn(a, b, xx, xr, seq, FORGET_BIAS, reset_mask=reset)

    _, vjp = jref.jax.vjp(layer, jfw, jbw, jnp.asarray(x), x_rev)
    c = [jnp.asarray(v) for v in cots]
    grads = vjp((c[0], c[1], ((c[2], c[3]), (c[4], c[5]))))
    return grads, np.array(x_rev)


def port_grads(fw, bw, x, x_rev, seq_len, reset_mask, cots):
    fw = {k: v.clone().requires_grad_() for k, v in fw.items()}
    bw = {k: v.clone().requires_grad_() for k, v in bw.items()}
    xt = torch.from_numpy(x).requires_grad_()
    xr = torch.from_numpy(x_rev).requires_grad_()
    fw_out, bw_out, ((cf, hf), (cb, hb)) = \
        lstm_kernels.bilstm_dual_scan_train(
            fw, bw, xt, xr, torch.from_numpy(seq_len), FORGET_BIAS,
            reset_mask=None if reset_mask is None
            else torch.from_numpy(reset_mask), store_dtype=torch.float32)
    total = sum((o * torch.from_numpy(c)).sum()
                for o, c in zip((fw_out, bw_out, cf, hf, cb, hb), cots))
    total.backward()
    return ({k: v.grad for k, v in fw.items()},
            {k: v.grad for k, v in bw.items()}, xt.grad, xr.grad)


def scan_fn(jref):
    return jref.cells.bilstm_dual_scan


def fused_fn(jref):
    def fused(*args, **kwargs):
        return jref.fused(*args, time_block=4, store_dtype="float32",
                          interpret=True, **kwargs)
    return fused


@pytest.mark.parametrize("reference", [fused_fn, scan_fn])
@pytest.mark.parametrize("seed,peep,proj,reset", [
    (0, True, 8, False), (1, False, 8, False), (2, True, None, False),
    (3, True, 8, True), (4, False, None, True)])
def test_layer_backward_matches_jax(jref, reference, seed, peep, proj,
                                    reset):
    fw, bw, x, seq_len, reset_mask, cots = random_case(
        seed, peepholes=peep, proj=proj, reset=reset)
    ref, x_rev = jax_vjp(jref, reference(jref), fw, bw, x, seq_len,
                         reset_mask, cots)
    before = lstm_kernels.lstm_layer_backward.launches
    got = port_grads(fw, bw, x, x_rev, seq_len, reset_mask, cots)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert lstm_kernels.lstm_layer_backward.launches == before
    for side in (0, 1):
        assert sorted(got[side]) == sorted(ref[side])
        for name in got[side]:
            np.testing.assert_allclose(got[side][name].numpy(),
                                       np.asarray(ref[side][name]),
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), **TOL)


def backward_args(seed, device="cpu", dtype=torch.float32, store=None,
                  proj=8, reset=True, cot_scale=1.0, **shape):
    """The backward wrapper's arguments for one layer: the forward run
    through ``lstm_layer_forward`` with states in the store dtype, and
    cotangents drawn from N(0, cot_scale²)."""
    store = store or dtype
    fw, bw, x, seq_len, reset_mask, _ = random_case(seed, proj=proj,
                                                    reset=reset, **shape)
    fw = {k: v.to(device) for k, v in fw.items()}
    bw = {k: v.to(device) for k, v in bw.items()}
    xt = torch.from_numpy(x).to(device)
    seq = torch.from_numpy(seq_len).to(device)
    gx, wh, pj, peep = cells.layer_inputs(
        fw, bw, xt, cells.reverse_sequence(xt, seq), dtype)
    _, keep = cells.step_masks(
        seq, None if reset_mask is None else torch.from_numpy(reset_mask),
        x.shape[1], device)
    args = (gx, seq, keep, wh, pj, peep, FORGET_BIAS)
    out, cfin, hfin, c_all, h_all = lstm_kernels.lstm_layer_forward(
        *args, states=True, store_dtype=store)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = (cot_scale * torch.randn(out.shape, generator=gen)).to(device)
    dcfin = (cot_scale * torch.randn(cfin.shape, generator=gen)).to(device)
    dhfin = (cot_scale * torch.randn(hfin.shape, generator=gen)).to(device)
    return args + (c_all, h_all, dout, dcfin, dhfin)


@pytest.mark.parametrize("proj,reset", [(8, True), (None, False)])
def test_replay_backward_steps_reproduces_plain_carries(proj, reset):
    """Each step replayed from the carries entering it gives the carries
    entering the step before, and the same dgates."""
    args = backward_args(5, proj=proj, reset=reset)
    dgates, _, _, _, dc_in, dh_in = lstm_kernels.lstm_layer_backward(
        *args, steps=True)
    assert torch.equal(dc_in[-1], args[-2]) and torch.equal(dh_in[-1],
                                                            args[-1])
    dg, dc_out, dh_out = cells.replay_backward_steps(*args[:-2], dc_in,
                                                     dh_in)
    np.testing.assert_allclose(dg.numpy(), dgates.numpy(), **TOL)
    np.testing.assert_allclose(dc_out[1:].numpy(), dc_in[:-1].numpy(), **TOL)
    np.testing.assert_allclose(dh_out[1:].numpy(), dh_in[:-1].numpy(), **TOL)


def test_store_dtype_rounds_states_and_dgates():
    args = backward_args(6, store=torch.bfloat16)
    assert args[7].dtype == torch.bfloat16 and args[8].dtype == torch.bfloat16
    dgates, dwh, dproj, dpeep = lstm_kernels.lstm_layer_backward(
        *args, store_dtype=torch.bfloat16)
    assert dgates.dtype == torch.bfloat16
    assert dwh.dtype == dproj.dtype == dpeep.dtype == torch.float32


def test_backward_wrapper_refuses_other_devices():
    args = backward_args(7)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_kernels.lstm_layer_backward(*meta)


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


# the tests' small widths (padded in the cluster layout), and the flagship
# layer, B=32, T=384, H=P=320, with the cotangents' scale of chip_smoke.py's
# phase 7 (0.1): dgates' one-rounding-step bound has an absolute floor of
# 1e-6, and at unit scale, near a cancellation in dout_blk, two float32
# orders of its sum can put one of the 31M dgates past it
SMALL = dict(batch=5, time_steps=40)
FLAGSHIP = dict(batch=32, time_steps=384, units=320, cot_scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("proj,reset,shape", [
    (8, True, SMALL), (8, False, SMALL), (None, True, SMALL),
    (320, True, FLAGSHIP), (None, False, FLAGSHIP)])
def test_kernel_matches_plain_on_gpu_f32(cuda, proj, reset, shape):
    args = backward_args(8, cuda, proj=proj, reset=reset, **shape)
    before = lstm_kernels.lstm_layer_backward.launches
    got = lstm_kernels.lstm_layer_backward(*args)
    ref = cells.dual_recurrence_backward(*args)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_layer_backward.launches == before + 1
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert ratio(g, r) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("proj,shape", [(8, SMALL), (320, FLAGSHIP),
                                        (None, FLAGSHIP)])
def test_kernel_steps_replay_on_gpu_bf16(cuda, proj, shape):
    args = backward_args(9, cuda, dtype=torch.bfloat16, proj=proj, **shape)
    dgates, dwh, dproj, dpeep, dc_in, dh_in = (
        lstm_kernels.lstm_layer_backward(*args, store_dtype=torch.bfloat16,
                                         steps=True))
    dg, dc_out, dh_out, wgrads = cells.replay_backward_steps(
        *args[:-2], dc_in, dh_in, store_dtype=torch.bfloat16, dgates=dgates)
    assert ratio(dc_out[1:], dc_in[:-1]) <= 1e-3
    assert ratio(dh_out[1:], dh_in[:-1]) <= 1e-3
    # dgates is stored in bf16: one rounding step apart at most
    diff = (dgates.float() - dg.float()).abs()
    assert bool((diff <= 2.0 ** -7 * dg.float().abs() + 1e-6).all())
    # the tensor-core weight gradients against the plain sums over the
    # kernel's own dgates and the steps' stashes
    for g, r in zip((dwh, dproj, dpeep), wgrads):
        assert (g is None) == (r is None)
        if g is not None:
            assert ratio(g, r) <= 1e-3


def test_replay_weight_grads_match_the_backward():
    # over the plain backward's own dgates and carries, the replay's weight
    # gradients are the plain backward's
    args = backward_args(10)
    dgates, dwh, dproj, dpeep, dc_in, dh_in = cells.dual_recurrence_backward(
        *args, steps=True)
    _, _, _, wgrads = cells.replay_backward_steps(*args[:-2], dc_in, dh_in,
                                                  dgates=dgates)
    for g, r in zip((dwh, dproj, dpeep), wgrads):
        torch.testing.assert_close(r, g, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_bf16_slices_past_shared_memory(cuda):
    # as K1 does: at H = P = 1024 without a projection the bf16 slices do
    # not fit in a block's shared memory even with 16 blocks, so K2 takes
    # the streamed plan (16 blocks, most of the slices streamed from L2 at
    # every step); float32 reads its slices from L2 and launches the
    # resident body, with 8 blocks of 128 units; past 2048 units (128 a
    # block) K2 has no plan
    how = lstm_kernels.backward_config(cuda, 5, 1024, 1024, False,
                                       torch.bfloat16)
    assert how["streamed"] and how["blocks"] == 16 and how["rows"] > 0
    assert how["streamed_bytes"] > how["held_bytes"]
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(RuntimeError, match="lstm_bwd_config"):
            lstm_kernels.backward_config(cuda, 5, 2052, 2052, False, dtype)
    how = lstm_kernels.backward_config(cuda, 5, 1024, 1024, False,
                                       torch.float32)
    assert how["rows"] > 0 and how["blocks"] == 8 and not how["streamed"]
    # H = P = 384 in bf16, which 8 blocks cannot hold, takes 16
    assert lstm_kernels.backward_config(cuda, 5, 384, 384, True,
                                        torch.bfloat16)["blocks"] == 16
