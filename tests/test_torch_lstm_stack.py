"""The unidirectional stack (``ops/lstm_stack_kernels``: K12, K13).

On the CPU ``lstm_stack_fused`` runs the plain versions of both kernels
(``stack_forward_reference``, ``stack_backward_reference``).  They are held
against the JAX package's ``lstm_stack_fused`` (the Pallas wavefront
kernels in interpret mode, store float32) on the same weights and inputs
from a numpy seed, at rtol = atol = 1e-5 (float32 on both sides, sums in
another order): outputs, final states, every weight gradient and dx, for
both families, with ragged lengths and residual flags; initial states and
their gradients; hash dropout at keep 0.8 from the same int32 seed, whose
mask must equal JAX's bit for bit; the eval-BN affine, whose backward
raises.  The ``cuda`` tests hold K12 and K13 against their plain versions
on the card, narrow, at the ``lstm`` and ``cudnnlstm`` widths, and at the
widths that take 16-block clusters (up to H = 1024, P = 256): max|diff|
/ max|plain| <= 1e-4 per output in float32, and in bfloat16 each step
replayed from the kernels' own states within 1e-3, as are K13's weight
gradients over its own dgates; two bfloat16 launches bit-equal.
JAX is imported by a fixture, so the ``cuda`` tests also run where JAX is
not installed (pytest --noconftest).
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk

B, T, H, P, D0 = 4, 20, 16, 12, 24
TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {  # (projection, peepholes, residual flags)
    "cudnnlstm": (None, False, (False, False, False)),
    "lstm": (P, True, (False, True, True)),
}


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import cells as jcells
    from lstm_ctc_tpu.ops import lstm_stack_pallas
    from lstm_ctc_tpu.ops.moe_pallas import hash_uniform
    return types.SimpleNamespace(jax=jax, jnp=jnp, cells=jcells,
                                 stack=lstm_stack_pallas,
                                 hash_uniform=hash_uniform)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_stack(seed, num_layers=3, num_proj=P, peepholes=True, d0=D0,
               units=H, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    params, d = [], d0
    for _ in range(num_layers):
        params.append(cells.init_lstm_cell(gen, d, units, num_proj, peepholes,
                                           device))
        d = num_proj or units
    rng = np.random.RandomState(seed)
    for p in params:   # non-zero biases, so that the bias paths count
        p["bias"] = torch.from_numpy(
            (0.1 * rng.randn(p["bias"].shape[0])).astype(np.float32)).to(
                device)
    return params


def inputs(seed, batch=B, time_steps=T, dim=D0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq = np.array([time_steps, time_steps - 3, 5, 1][:batch], np.int32)
    return x, seq


def to_jax(jref, params):
    return [{k: jref.jnp.asarray(v.detach().numpy()) for k, v in p.items()}
            for p in params]


def jax_stack(jref, jparams, x, seq, flags, **kw):
    return jref.stack.lstm_stack_fused(
        jparams, jref.jnp.asarray(x), jref.jnp.asarray(seq), 1.0,
        residual_flags=tuple(flags), store_dtype="float32", time_block=8,
        interpret=True, **kw)


def close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=msg, **TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(jref, family):
    proj, peep, flags = FAMILIES[family]
    params = make_stack(0, num_proj=proj, peepholes=peep)
    x, seq = inputs(0)
    want, want_states = jax_stack(jref, to_jax(jref, params), x, seq, flags)
    got, states = sk.lstm_stack_fused(params, torch.from_numpy(x),
                                      torch.from_numpy(seq), 1.0,
                                      residual_flags=flags)
    close(got, want, "outputs")
    for l, ((c, h), (wc, wh)) in enumerate(zip(states, want_states)):
        close(c, wc, "c of layer %d" % l)
        close(h, wh, "h of layer %d" % l)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_layer_scans(family):
    """The plain K12 equals the per-layer composition of ``lstm_scan``."""
    proj, peep, flags = FAMILIES[family]
    params = make_stack(1, num_proj=proj, peepholes=peep)
    x, seq = (torch.from_numpy(a) for a in inputs(1))
    got, states = sk.lstm_stack_fused(params, x, seq, 1.0,
                                      residual_flags=flags)
    out = x
    for l, (p, r) in enumerate(zip(params, flags)):
        y, (c, h) = cells.lstm_scan(p, out, seq)
        out = y + out if r else y
        close(states[l][0], c.numpy())
        close(states[l][1], h.numpy())
    close(got, out.numpy())


def port_grads(params, x, seq, flags, **kw):
    leaves = [t.requires_grad_() for p in params for t in p.values()]
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = sk.lstm_stack_fused(params, xt, torch.from_numpy(seq), 1.0,
                                 residual_flags=flags,
                                 store_dtype=torch.float32, **kw)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves + [xt])
    return out, grads[:-1], grads[-1]


def jax_grads(jref, jparams, x, seq, flags, **kw):
    def loss(ps, xs):
        out, _ = jref.stack.lstm_stack_fused(
            ps, xs, jref.jnp.asarray(seq), 1.0, residual_flags=tuple(flags),
            store_dtype="float32", time_block=8, interpret=True, **kw)
        return jref.jnp.sum(jref.jnp.sin(out))
    return jref.jax.grad(loss, argnums=(0, 1))(jparams, jref.jnp.asarray(x))


def assert_grads_match(params, got_p, got_x, want_p, want_x):
    close(got_x, want_x, "dx")
    i = 0
    for l, p in enumerate(params):
        for name in p:
            close(got_p[i], want_p[l][name], "layer %d d%s" % (l, name))
            i += 1


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_match_jax(jref, family):
    proj, peep, flags = FAMILIES[family]
    params = make_stack(2, num_proj=proj, peepholes=peep)
    x, seq = inputs(2)
    want_p, want_x = jax_grads(jref, to_jax(jref, params), x, seq, flags)
    _, got_p, got_x = port_grads(params, x, seq, flags)
    assert_grads_match(params, got_p, got_x, want_p, want_x)


def test_initial_states_and_their_gradients(jref):
    jnp = jref.jnp
    params = make_stack(3)
    x, seq = inputs(3)
    rng = np.random.RandomState(3)
    init = [(0.1 * rng.randn(B, H)).astype(np.float32) for _ in range(3)] + \
        [(0.1 * rng.randn(B, P)).astype(np.float32) for _ in range(3)]
    flags = FAMILIES["lstm"][2]
    jparams = to_jax(jref, params)

    def jloss(*st):
        out, states = jax_stack(jref, jparams, x, seq, flags,
                                initial_states=list(zip(st[:3], st[3:])))
        return jnp.sum(jnp.sin(out)) + sum(jnp.sum(c * c) + jnp.sum(h)
                                           for c, h in states)

    want = jref.jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in init])
    tinit = [torch.from_numpy(a).requires_grad_() for a in init]
    out, states = sk.lstm_stack_fused(
        params, torch.from_numpy(x), torch.from_numpy(seq), 1.0,
        residual_flags=flags, store_dtype=torch.float32,
        initial_states=list(zip(tinit[:3], tinit[3:])))
    want_out, want_states = jax_stack(
        jref, jparams, x, seq, flags,
        initial_states=[(jnp.asarray(c), jnp.asarray(h))
                        for c, h in zip(init[:3], init[3:])])
    close(out, want_out)
    for (c, h), (wc, wh) in zip(states, want_states):
        close(c, wc)
        close(h, wh)
    loss = torch.sin(out).sum() + sum((c * c).sum() + h.sum()
                                      for c, h in states)
    for g, w in zip(torch.autograd.grad(loss, tinit), want):
        close(g, w, "initial-state gradient")


def test_dropout_mask_is_jax_bit_for_bit(jref):
    seed, keep = 12345, 0.8
    steps, layers = T + 2, 3
    got = sk._drop_mask(torch.tensor([seed], dtype=torch.int32), keep, steps,
                        layers, B, P, "cpu")
    want = np.stack([np.asarray(jref.hash_uniform(
        jref.jnp.asarray(seed, jref.jnp.int32), s * layers * B, 0,
        layers * B, P) < keep) for s in range(steps)])
    np.testing.assert_array_equal((got > 0).numpy().reshape(want.shape),
                                  want)
    kept = got[got > 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0 / keep))


def test_dropout_matches_jax(jref):
    params = make_stack(4)
    x, seq = inputs(4)
    flags = FAMILIES["lstm"][2]
    kw = dict(keep_prob=0.8)
    want_out, _ = jax_stack(jref, to_jax(jref, params), x, seq, flags,
                            seed=jref.jnp.asarray([12345], jref.jnp.int32),
                            **kw)
    want_p, want_x = jax_grads(jref, to_jax(jref, params), x, seq, flags,
                               seed=jref.jnp.asarray([12345], jref.jnp.int32),
                               **kw)
    out, got_p, got_x = port_grads(
        params, x, seq, flags,
        seed=torch.tensor([12345], dtype=torch.int32), **kw)
    close(out, want_out, "outputs")
    assert_grads_match(params, got_p, got_x, want_p, want_x)


def affine_rows(seed, layers=3, width=P):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy((0.5 + rng.rand(width)).astype(np.float32)),
             torch.from_numpy((0.2 * rng.randn(width)).astype(np.float32)))
            for _ in range(layers)]


def test_affine_matches_jax_and_is_forward_only(jref):
    params = make_stack(5)
    x, seq = inputs(5)
    flags = FAMILIES["lstm"][2]
    affine = affine_rows(5)
    want, want_states = jax_stack(
        jref, to_jax(jref, params), x, seq, flags,
        affine=[(jref.jnp.asarray(a.numpy()), jref.jnp.asarray(b.numpy()))
                for a, b in affine])
    got, states = sk.lstm_stack_fused(params, torch.from_numpy(x),
                                      torch.from_numpy(seq), 1.0,
                                      residual_flags=flags, affine=affine)
    close(got, want)
    for (c, h), (wc, wh) in zip(states, want_states):
        close(c, wc)
        close(h, wh)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = sk.lstm_stack_fused(params, xt, torch.from_numpy(seq), 1.0,
                                 residual_flags=flags, affine=affine)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


def test_stack_eligible_rules(jref):
    """The cases of the JAX package's own test (a uniform stack; a single
    layer; a layer-0 residual), and mixed widths."""
    ok = make_stack(6)
    assert sk.stack_eligible(ok)
    assert not sk.stack_eligible(ok[:1])
    p0 = cells.init_lstm_cell(torch.Generator().manual_seed(0), P, H, P, True)
    assert not sk.stack_eligible([p0] + ok[1:])
    assert not sk.stack_eligible(ok[:1] + make_stack(7, num_layers=2,
                                                     units=8, d0=P))
    assert not sk.stack_eligible(ok[:1] + make_stack(8, num_layers=2,
                                                     peepholes=False, d0=P))
    jok = to_jax(jref, ok)
    assert jref.stack.stack_eligible(jok)
    assert not jref.stack.stack_eligible(jok[:1])
    assert not jref.stack.stack_eligible(to_jax(jref, [p0]) + jok[1:])


def test_chunked_continuation_matches_one_shot():
    """Two chunks with the per-layer (c, h) carried equal one run."""
    params = make_stack(9)
    x, _ = inputs(9)
    x = torch.from_numpy(x)
    flags = FAMILIES["lstm"][2]
    full = torch.full((B,), T, dtype=torch.int32)
    half = torch.full((B,), T // 2, dtype=torch.int32)
    want, want_states = sk.lstm_stack_fused(params, x, full, 1.0,
                                            residual_flags=flags)
    out1, st1 = sk.lstm_stack_fused(params, x[:, :T // 2], half, 1.0,
                                    residual_flags=flags)
    out2, st2 = sk.lstm_stack_fused(params, x[:, T // 2:], half, 1.0,
                                    residual_flags=flags, initial_states=st1)
    close(torch.cat([out1, out2], 1), want.numpy())
    for (c, h), (wc, wh) in zip(st2, want_states):
        close(c, wc.numpy())
        close(h, wh.numpy())


def stack_case(seed, device, dtype, keep=1.0, affine=False, init=False,
               batch=B, time_steps=T, units=H, proj=P, dim=D0, layers=3,
               lengths=None):
    """K12's arguments from a seed, as ``lstm_stack_fused`` builds them."""
    params = make_stack(seed, layers, proj, proj is not None, dim, units,
                        device)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, time_steps, dim).astype(
        np.float32)).to(device)
    if lengths is None:
        lengths = rng.randint(time_steps // 2, time_steps + 1, batch)
        lengths[0] = time_steps
    seq = torch.from_numpy(np.asarray(lengths, np.int32)).to(device)
    wz, bias, proj_w, peep = sk.stack_weights(params, dtype)
    gx = torch.matmul(x.to(dtype), params[0]["wx"].to(dtype)).float() \
        + params[0]["bias"]
    gx0 = torch.nn.functional.pad(gx.transpose(0, 1),
                                  (0, 0, 0, 0, 0, layers - 1)).contiguous()
    mask = sk.stack_mask(seq, time_steps, layers, device)
    out_dim = proj or units
    lb = layers * batch

    def state(width):
        scale = 0.1 if init else 0.0
        return torch.from_numpy((scale * rng.randn(lb, width)).astype(
            np.float32)).to(device)

    residual = (False,) + (proj is not None,) * (layers - 1)
    seed_t = torch.tensor([-1234567], dtype=torch.int32, device=device)
    aff = None
    if affine:
        aff = tuple(torch.stack(v).to(device)
                    for v in zip(*affine_rows(seed, layers, out_dim)))
    return dict(gx0=gx0, mask=mask, wz=wz, bias=bias, proj=proj_w, peep=peep,
                cinit=state(units), hinit=state(out_dim), residual=residual,
                forget_bias=1.0, keep_prob=keep, seed=seed_t, affine=aff)


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def test_replays_reproduce_the_plain_streams():
    """The per-step replays (``chip_smoke.py``'s bfloat16 checks) give back
    the plain versions' own streams."""
    case = stack_case(10, "cpu", torch.float32, keep=0.8, init=True)
    out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
        **case, states=True)
    replay = sk.stack_replay_steps(**case, chain=chain, c_all=c_all,
                                   h_all=h_all)
    for got, want in zip(replay, (chain, c_all, h_all)):
        close(got, want.numpy())
    bwd_case = {k: v for k, v in case.items() if k != "affine"}
    rng = np.random.RandomState(10)
    dout = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    grads = sk.lstm_stack_backward(
        **bwd_case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
        dcfin=torch.zeros_like(cfin), dhfin=torch.zeros_like(hfin),
        steps_out=True)
    dgates, dc_in, dh_in, din = grads[0], grads[7], grads[8], grads[9]
    dg, dc_out, dh_out, din_out = sk.stack_replay_backward_steps(
        **bwd_case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
        dc_in=dc_in, dh_in=dh_in, din=din)
    close(dg, dgates.numpy())
    close(dc_out[1:], dc_in[:-1].numpy())
    close(dh_out[1:], dh_in[:-1].numpy())
    close(din_out[1:], din[1:].numpy())
    close(dc_out[0], grads[5].numpy())


@pytest.mark.parametrize("proj", [P, None])
def test_replay_weight_grads_match_the_backward(proj):
    """Over the plain backward's own dgates, the replay's weight gradients
    (what the ``cuda`` tests and ``chip_smoke.py`` hold K13's to) are the
    plain backward's."""
    case = stack_case(14, "cpu", torch.float32, keep=0.8, init=True,
                      proj=proj)
    case.pop("affine")
    out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
        **case, states=True)
    dout = torch.from_numpy(np.random.RandomState(14).randn(
        *out.shape).astype(np.float32))
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all, dout=dout)
    grads = sk.lstm_stack_backward(**args, dcfin=torch.zeros_like(cfin),
                                   dhfin=torch.zeros_like(hfin),
                                   steps_out=True)
    *_, wgrads = sk.stack_replay_backward_steps(
        **args, dc_in=grads[7], dh_in=grads[8], din=grads[9],
        dgates=grads[0])
    for got, want in zip(grads[1:5], wgrads):
        if got is None:
            assert want is None
        else:
            close(want, got.numpy())


# (units, proj): narrow, and the lstm and cudnnlstm widths
WIDTHS = [(16, P), (16, None), (320, 320), (320, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("keep,affine,init", [
    (1.0, False, False), (0.9, False, True), (1.0, True, True)])
@pytest.mark.parametrize("units,proj", WIDTHS)
def test_k12_matches_plain_f32(cuda, keep, affine, init, units, proj):
    case = stack_case(11, cuda, torch.float32, keep, affine, init, batch=5,
                      proj=proj, units=units)
    got = sk.lstm_stack_forward(**case, states=True)
    ref = sk.stack_forward_reference(**case)
    ref = (ref[0], ref[4], ref[5]) + ref[1:4]
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert ratio(g, r) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("units,proj", WIDTHS)
@pytest.mark.parametrize("batch", [5, 301])  # 301: more than one wave
def test_k13_matches_plain_f32(cuda, keep, units, proj, batch):
    case = stack_case(12, cuda, torch.float32, keep, init=True, batch=batch,
                      proj=proj, units=units,
                      time_steps=T if batch < 100 else 6,
                      lengths=None if batch < 100 else
                      np.random.RandomState(batch).randint(1, 7, batch))
    case.pop("affine")
    out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
        **case, states=True)
    rng = np.random.RandomState(12)
    dout = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(cuda)
    dcfin = torch.from_numpy(rng.randn(*cfin.shape).astype(np.float32)).to(cuda)
    dhfin = torch.from_numpy(rng.randn(*hfin.shape).astype(np.float32)).to(cuda)
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
                dcfin=dcfin, dhfin=dhfin)
    got = sk.lstm_stack_backward(**args)
    ref = sk.stack_backward_reference(**args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        if r is not None:
            assert ratio(g, r) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("units,proj", [(32, 16), (320, 320), (320, None)])
def test_k12_k13_bf16_steps_replay(cuda, units, proj):
    """bfloat16: each step of both kernels from their own states, and K13's
    weight gradients over its own dgates and the replayed steps' stashes.
    The cotangents are scaled by 0.1, as chip_smoke.py's: at unit scale a
    dgates value near a cancellation lies past the bound's floor."""
    case = stack_case(13, cuda, torch.bfloat16, keep=0.9, init=True,
                      batch=6, time_steps=40, units=units, proj=proj)
    case.pop("affine")
    out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
        **case, states=True)
    replay = sk.stack_replay_steps(**case, affine=None, chain=chain,
                                   c_all=c_all, h_all=h_all)
    assert max(ratio(g, r) for g, r in zip((chain, c_all, h_all), replay)) \
        <= 1e-3
    dout = 0.1 * torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(0)).to(cuda)
    grads = sk.lstm_stack_backward(
        **case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
        dcfin=torch.zeros_like(cfin), dhfin=torch.zeros_like(hfin),
        steps_out=True)
    dc_in, dh_in, din = grads[7:]
    _, dc_out, dh_out, din_out, wgrads = sk.stack_replay_backward_steps(
        **case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
        dc_in=dc_in, dh_in=dh_in, din=din, dgates=grads[0])
    assert max(ratio(dc_out[1:], dc_in[:-1]), ratio(dh_out[1:], dh_in[:-1]),
               ratio(din_out[1:], din[1:])) <= 1e-3
    # dwz, dbias, dproj, dpeep
    for got, want in zip((grads[1], grads[2], grads[3], grads[4]), wgrads):
        if want is not None:
            assert ratio(got, want) <= 1e-3


# the widths past the 8-block plans, on 16-block clusters: Kaldi's LSTMP
# cell and projection, H = P = 384-512 with a projection, and 512 without
WIDE = [(1024, 256), (512, 512), (448, 448), (384, 384), (512, None)]


def blocks(cuda, case, backward=False, store=None):
    steps, batch, h4 = case["gx0"].shape
    layers, p2, _ = case["wz"].shape
    return sk.stack_config(cuda, steps, layers, batch, h4 // 4, p2 // 2,
                           case["proj"] is not None, case["wz"].dtype,
                           backward, store or case["wz"].dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("units,proj", WIDE)
def test_k12_k13_wide_on_16_blocks(cuda, units, proj):
    """K12 and K13 on 16-block clusters: float32 against the plain versions
    at keep 0.9 with initial states (ratio <= 1e-4), at B = 5 (one row
    tile) and B = 20 (row tiles in waves); bfloat16 at B = 20 (K12 takes 16
    or 32 rows a cluster, several a cell-phase thread, a ragged last tile)
    each step replayed from the kernels' own states within 1e-3 (K12's in
    float32: it carries c in float32, which bf16 states would round), and
    K13's on states stored in float32 (one row a thread, R = 4) and in
    bf16 (8 or 16 rows), each step replayed within 1e-3 and its weight
    gradients over its own dgates; two bfloat16 launches bit-equal.  In
    float32, whose slices stay in L2, 8 blocks hold up to 512 units.  The
    flagship width keeps 8 blocks: K12 at R = 12 in one wave, K13 at R = 6
    in two."""
    for batch in (5, 20):
        case = stack_case(16, cuda, torch.float32, keep=0.9, init=True,
                          batch=batch, time_steps=12, units=units, proj=proj,
                          layers=4)
        case.pop("affine")
        f32_blocks = 16 if units > 512 else 8
        assert blocks(cuda, case)["blocks"] == f32_blocks
        assert blocks(cuda, case, True)["blocks"] == f32_blocks
        got = sk.lstm_stack_forward(**case, states=True)
        ref = sk.stack_forward_reference(**case)
        ref = (ref[0], ref[4], ref[5]) + ref[1:4]
        for g, r in zip(got, ref):
            assert ratio(g, r) <= 1e-4
        out, cfin, hfin, chain, c_all, h_all = got
        rng = np.random.RandomState(batch)
        cots = [torch.from_numpy(0.1 * rng.randn(*t.shape).astype(
            np.float32)).to(cuda) for t in (out, cfin, hfin)]
        args = dict(case, chain=chain, c_all=c_all, h_all=h_all, dout=cots[0],
                    dcfin=cots[1], dhfin=cots[2])
        grads = sk.lstm_stack_backward(**args)
        want = sk.stack_backward_reference(**args)
        torch.cuda.synchronize()
        for g, r in zip(grads, want):
            if r is not None:
                assert ratio(g, r) <= 1e-4
    case = stack_case(17, cuda, torch.bfloat16, keep=0.9, init=True,
                      batch=20, time_steps=24, units=units, proj=proj,
                      layers=4)
    case.pop("affine")
    how = blocks(cuda, case)
    assert how["blocks"] == 16 and how["rows"] >= 16
    first = sk.lstm_stack_forward(**case, states=True)
    again = sk.lstm_stack_forward(**case, states=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    out, cfin, hfin, chain, c_all, h_all = first
    replay = sk.stack_replay_steps(**case, affine=None, chain=chain,
                                   c_all=c_all, h_all=h_all)
    assert max(ratio(g, r) for g, r in zip((chain, c_all, h_all), replay)) \
        <= 1e-3
    dout = 0.1 * torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(0)).to(cuda)
    for store, rows in ((torch.float32, 4), (torch.bfloat16, 8)):
        how = blocks(cuda, case, True, store)
        assert how["blocks"] == 16 and not how["streamed"]
        assert how["rows"] >= rows
        out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
            **case, states=True, store_dtype=store)
        args = dict(case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
                    dcfin=torch.zeros_like(cfin),
                    dhfin=torch.zeros_like(hfin), store_dtype=store)
        grads = sk.lstm_stack_backward(**args, steps_out=True)
        twice = sk.lstm_stack_backward(**args, steps_out=True)
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(grads, twice))
        dc_in, dh_in, din = grads[7:]
        replay_args = {k: v for k, v in args.items() if k not in ("dcfin",
                                                                 "dhfin")}
        _, dc_out, dh_out, din_out, wgrads = sk.stack_replay_backward_steps(
            **replay_args, dc_in=dc_in, dh_in=dh_in, din=din,
            dgates=grads[0])
        assert max(ratio(dc_out[1:], dc_in[:-1]),
                   ratio(dh_out[1:], dh_in[:-1]),
                   ratio(din_out[1:], din[1:])) <= 1e-3, store
        for got, want in zip(grads[1:5], wgrads):
            if want is not None:
                assert ratio(got, want) <= 1e-3, store
    flagship = stack_case(18, cuda, torch.bfloat16, batch=32, time_steps=8,
                          units=320, proj=320, layers=4)
    how = blocks(cuda, flagship)
    assert (how["blocks"], how["rows"], how["waves"]) == (8, 12, 1)
    how = blocks(cuda, flagship, True)
    assert (how["blocks"], how["rows"], how["waves"]) == (8, 6, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [32, 21])
@pytest.mark.parametrize("units,proj", WIDE)
def test_k12_k13_resident_rows_equal_four_rows(cuda, units, proj, batch):
    """On the resident plan of 16 blocks (bf16, bf16 states) a B = 32 stack
    launches K12 at 16 or 32 rows a cluster in at most two waves and K13 at
    8 or 16 in at most four (a cell-phase thread owns several rows; K13 runs
    the streamed plan's kernel with every weight held), and gives the bits
    of the same launch forced at R = 4, one row a thread, row for row:
    K12's outputs and states; K13's dgates, weight products, carries and
    din.  K13's column sums add each thread's rows before the threads':
    within 1e-5 of R = 4's.  B = 21 leaves a ragged last tile."""
    case = stack_case(23, cuda, torch.bfloat16, keep=0.9, init=True,
                      batch=batch, time_steps=10, units=units, proj=proj,
                      layers=4)
    case.pop("affine")
    bf16 = torch.bfloat16
    for backward, most in ((False, 2), (True, 4)):
        how = blocks(cuda, case, backward)
        assert how["blocks"] == 16 and not how["streamed"]
        assert how["rows"] >= (8 if backward else 16) and how["waves"] <= most
    four = ("resident", 4)
    got = sk.lstm_stack_forward(**case, states=True, store_dtype=bf16)
    want = sk.lstm_stack_forward(**case, states=True, store_dtype=bf16,
                                 _plan=four)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, cfin, hfin, chain, c_all, h_all = got
    gen = torch.Generator().manual_seed(1)
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                dout=0.1 * torch.randn(out.shape, generator=gen).to(cuda),
                dcfin=torch.randn(cfin.shape, generator=gen).to(cuda),
                dhfin=torch.randn(hfin.shape, generator=gen).to(cuda),
                store_dtype=bf16)
    grads = sk.lstm_stack_backward(**args, steps_out=True)
    ref = sk.lstm_stack_backward(**args, steps_out=True, _plan=four)
    names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit", "dhinit",
             "dc_in", "dh_in", "din")
    for name, g, r in zip(names, grads, ref):
        if r is None:
            assert g is None, name
        elif name in ("dbias", "dpeep"):
            assert ratio(g, r) <= 1e-5, name
        else:
            assert torch.equal(g, r), name


# the streamed plan's widths (bf16 slices that fit no resident plan, 16
# blocks): Sak, Senior and Beaufays' LSTMP (2048 cells, projection 512: 128
# units a block), the cudnnlstm family at H = P = 768, 1024 and 2048
STREAMED = [(2048, 512), (768, None), (1024, None), (2048, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("units,proj", STREAMED)
def test_k12_k13_streamed_plan(cuda, units, proj):
    """K12 and K13 on the streamed plan: bfloat16 each step replayed from
    the kernels' own states within 1e-3, K13's weight gradients over its
    own dgates, two launches bit-equal, the plan streamed on 16 blocks;
    float32 (its slices read from L2, 128 units a block past 1024) against
    the plain versions at ratio <= 1e-4 (K13's din product staging fewer
    rows at H = P = 2048, where 32 rows of P do not fit).  At B = 4, T =
    32 a chunk's 5
    steps of 4 rows spill into a second input stage where a stage holds 16
    rows (P past 512), whose blocks own 128 units: each of a warp's two
    tiles of gate columns takes its own bias in every stage."""
    case = stack_case(19, cuda, torch.bfloat16, keep=0.9, init=True, batch=4,
                      time_steps=32, units=units, proj=proj, layers=4)
    case.pop("affine")
    for backward in (False, True):
        how = blocks(cuda, case, backward)
        assert how["blocks"] == 16 and how["streamed"]
        assert how["streamed_bytes"] > 0
    first = sk.lstm_stack_forward(**case, states=True)
    again = sk.lstm_stack_forward(**case, states=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    out, cfin, hfin, chain, c_all, h_all = first
    replay = sk.stack_replay_steps(**case, affine=None, chain=chain,
                                   c_all=c_all, h_all=h_all)
    assert max(ratio(g, r) for g, r in zip((chain, c_all, h_all), replay)) \
        <= 1e-3
    dout = 0.1 * torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(0)).to(cuda)
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
                dcfin=torch.zeros_like(cfin), dhfin=torch.zeros_like(hfin))
    grads = sk.lstm_stack_backward(**args, steps_out=True)
    twice = sk.lstm_stack_backward(**args, steps_out=True)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(grads, twice))
    dc_in, dh_in, din = grads[7:]
    replay_args = {k: v for k, v in args.items() if k not in ("dcfin",
                                                             "dhfin")}
    _, dc_out, dh_out, din_out, wgrads = sk.stack_replay_backward_steps(
        **replay_args, dc_in=dc_in, dh_in=dh_in, din=din, dgates=grads[0])
    assert max(ratio(dc_out[1:], dc_in[:-1]), ratio(dh_out[1:], dh_in[:-1]),
               ratio(din_out[1:], din[1:])) <= 1e-3
    for got, want in zip(grads[1:5], wgrads):
        if want is not None:
            assert ratio(got, want) <= 1e-3
    if units < 2048:
        return
    case = stack_case(20, cuda, torch.float32, keep=0.9, init=True, batch=3,
                      time_steps=6, units=units, proj=proj, layers=2)
    case.pop("affine")
    assert not blocks(cuda, case)["streamed"]
    got = sk.lstm_stack_forward(**case, states=True)
    ref = sk.stack_forward_reference(**case)
    for g, r in zip(got, (ref[0], ref[4], ref[5]) + ref[1:4]):
        assert ratio(g, r) <= 1e-4
    out, cfin, hfin, chain, c_all, h_all = got
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                dout=0.1 * torch.ones_like(out), dcfin=torch.zeros_like(cfin),
                dhfin=torch.zeros_like(hfin))
    for g, r in zip(sk.lstm_stack_backward(**args),
                    sk.stack_backward_reference(**args)):
        if r is not None:
            assert ratio(g, r) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 8])
def test_k12_k13_forced_streamed_plan_equals_resident(cuda, rows):
    """At Kaldi's LSTMP widths (H = 1024, P = 256, resident on 16 blocks)
    the streamed plan forced at the same R (with half of wh resident, and
    with as much as fits) gives the resident plan's bits, forward and
    backward (K13 at R = 4, the streamed plan's largest).  K13's resident
    plan of 16 blocks runs the streamed plan's kernel with every weight
    held, so its half holds the held pass (no ring, a warp's dh half-tiles
    before its gate tiles) against the ring's within one kernel body; the
    8-block body is held to the plain version by the tests above."""
    case = stack_case(21, cuda, torch.bfloat16, keep=0.9, init=True,
                      batch=rows, time_steps=12, units=1024, proj=256,
                      layers=4)
    case.pop("affine")
    want = sk.lstm_stack_forward(**case, states=True,
                                 _plan=("resident", rows))
    for plan in ("streamed", "streamed, wh held as fits"):
        got = sk.lstm_stack_forward(**case, states=True, _plan=(plan, rows))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), plan
    if rows != 4:
        return
    out, cfin, hfin, chain, c_all, h_all = want
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                dout=0.1 * torch.ones_like(out), dcfin=torch.zeros_like(cfin),
                dhfin=torch.zeros_like(hfin))
    ref = sk.lstm_stack_backward(**args, _plan=("resident", rows))
    for plan in ("streamed", "streamed, wh held as fits"):
        got = sk.lstm_stack_backward(**args, _plan=(plan, rows))
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, ref)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [32, 21])
@pytest.mark.parametrize("units,proj", STREAMED[:3])
def test_k12_k13_streamed_rows_equal_four_rows(cuda, units, proj, batch):
    """On the streamed plan a B = 32 stack launches 16 or 32 rows a cluster
    (a cell-phase thread owns several rows) in at most two waves, and gives
    the bits of the same launch forced at R = 4, row for row: K12's outputs
    and states; K13's dgates, weight products, carries and din.  K13's
    column sums add each thread's rows before the threads': within 1e-5 of
    R = 4's.  B = 21 leaves a ragged last tile."""
    case = stack_case(22, cuda, torch.bfloat16, keep=0.9, init=True,
                      batch=batch, time_steps=10, units=units, proj=proj,
                      layers=4)
    case.pop("affine")
    for backward in (False, True):
        how = blocks(cuda, case, backward)
        assert how["streamed"] and how["rows"] >= 16 and how["waves"] <= 2
    four = ("streamed, wh held as fits", 4)
    got = sk.lstm_stack_forward(**case, states=True)
    want = sk.lstm_stack_forward(**case, states=True, _plan=four)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, cfin, hfin, chain, c_all, h_all = got
    gen = torch.Generator().manual_seed(1)
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                dout=0.1 * torch.randn(out.shape, generator=gen).to(cuda),
                dcfin=torch.randn(cfin.shape, generator=gen).to(cuda),
                dhfin=torch.randn(hfin.shape, generator=gen).to(cuda))
    grads = sk.lstm_stack_backward(**args, steps_out=True)
    ref = sk.lstm_stack_backward(**args, steps_out=True, _plan=four)
    names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit", "dhinit",
             "dc_in", "dh_in", "din")
    for name, g, r in zip(names, grads, ref):
        if r is None:
            assert g is None, name
        elif name in ("dbias", "dpeep"):
            assert ratio(g, r) <= 1e-5, name
        else:
            assert torch.equal(g, r), name
