"""The routes that send a shape the kernels refuse to the plain versions,
decided from the shapes before any launch, as the reference does: the
predicates ``ctc_kernels.dp_eligible``, ``moe_kernels.mix_eligible``,
``lstm_kernels.layer_eligible`` and ``lstm_stack_kernels.stack_eligible``
at their edges, one warning per process per reason, and the routed paths
against the JAX package on the CPU (a CTC lattice past 1024 positions, a
MoE head past 128 targets) at rtol = atol = 1e-5.  The ``cuda`` tests run
each refused shape on the card: equal to the plain version at the
existing bounds, one warning, and no kernel launch.  JAX is imported by a
fixture, so the ``cuda`` tests also run where JAX is not installed.
"""

import types
import warnings

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import blstm, cells, lstm, moe
from lstm_ctc_tpu_torch.ops import (ctc_kernels, lstm_kernels,
                                    lstm_stack_kernels, moe_kernels, route)
from lstm_ctc_tpu_torch.ops.ctc import ctc_loss

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import moe as jmoe
    from lstm_ctc_tpu.ops import ctc as jctc

    def weighted_loss(logits, seq_len, labels, label_len, weights):
        loss = jctc.ctc_loss(logits, seq_len, labels, label_len)
        return jnp.sum(loss * weights), loss

    # one compile for every case of a shape
    ctc_value_and_grad = jax.jit(jax.value_and_grad(weighted_loss,
                                                    has_aux=True))
    return types.SimpleNamespace(jax=jax, jnp=jnp, ctc=jctc, moe=jmoe,
                                 ctc_value_and_grad=ctc_value_and_grad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def fresh_warnings(monkeypatch):
    """A process that has warned of nothing yet."""
    monkeypatch.setattr(route, "_warned", set())


@pytest.fixture
def one_thread():
    """torch on one intra-op thread: the plain DP's thousands of small ops
    slow down ~50x when their thread pool shares busy cores (the suite's
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the predicates at their edges ---

@pytest.mark.parametrize("width,eligible", [(1, True), (1024, True),
                                            (1025, False)])
def test_dp_eligible_edges(width, eligible):
    assert ctc_kernels.dp_eligible(width) is eligible


@pytest.mark.parametrize("mode", moe_kernels.WGRAD_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,v", [(1024, 128), (1024, 129), (1025, 128),
                                 (1025, 129)])
def test_mix_eligible_edges(d, v, dtype, mode):
    # V <= 128 for every body; D <= 1024 for the float32 bodies only
    want = v <= 128 and (d <= 1024 or dtype == torch.bfloat16)
    assert moe_kernels.mix_eligible(d, v, dtype, mode) is want


def test_mix_eligible_refuses_unknown_modes():
    with pytest.raises(ValueError, match="wgrad_mode"):
        moe_kernels.mix_eligible(640, 72, torch.bfloat16, "fused")


@pytest.mark.parametrize("units,out_dim,train,eligible", [
    (512, 512, True, True), (513, 512, False, False), (513, 4, True, False),
    (320, 320, True, True), (6, 8, True, False), (8, 6, True, False),
    (6, 6, False, True), (10, 320, True, False)])
def test_layer_eligible_shape_edges(units, out_dim, train, eligible):
    """The shape-only part (a CPU device asks the library nothing): at most
    512 units; in training H and P divisible by 4 (6 and 10 are 2 mod 4)."""
    assert lstm_kernels.layer_eligible(torch.device("cpu"), units, out_dim,
                                       out_dim != units, torch.bfloat16,
                                       train) is eligible


class FakePlans:
    """The library's two plan queries, answering from a table of shapes
    and counting the questions; it has no other entry, so a predicate that
    called anything else (a CUDA call) would fail."""

    def __init__(self, fwd, bwd):
        self.fwd, self.bwd, self.asked = fwd, bwd, []

    def lstm_fwd_fits(self, units, out_dim, has_proj, bf16):
        self.asked.append(("fwd", units, out_dim, has_proj, bf16))
        return int((units, out_dim) in self.fwd)

    def lstm_bwd_fits(self, units, out_dim, has_proj, bf16, store_bf16):
        self.asked.append(("bwd", units, out_dim, has_proj, bf16,
                           store_bf16))
        return int((units, out_dim) in self.bwd)


@pytest.fixture
def fake_plans(monkeypatch, fresh_warnings):
    plans = FakePlans(fwd={(320, 320), (200, 448)}, bwd={(320, 320)})
    monkeypatch.setattr(lstm_kernels._build, "library", lambda: plans)
    lstm_kernels._unplanned.cache_clear()
    yield plans
    lstm_kernels._unplanned.cache_clear()


@pytest.mark.parametrize("units,out_dim,train,refused_by", [
    (320, 320, True, None), (320, 320, False, None),
    (384, 384, False, "forward (K1)"), (384, 384, True, "forward (K1)"),
    (200, 448, False, None), (200, 448, True, "backward (K2)")])
def test_layer_eligible_asks_the_plans_once_a_shape(fake_plans, units,
                                                    out_dim, train,
                                                    refused_by):
    """On a CUDA device the predicate asks K1's plan and, in training,
    K2's (with the compute and store dtypes), once a shape: the second
    question is answered from the cache.  A refusal names the kernel that
    has no plan, and nothing but the two plan queries is called."""
    cuda = torch.device("cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(2):
            got = lstm_kernels.layer_eligible(
                cuda, units, out_dim, True, torch.bfloat16, train,
                torch.float32, warn=True)
            assert got is (refused_by is None)
    want = [("fwd", units, out_dim, 1, 1)]
    if train and refused_by != "forward (K1)":
        want.append(("bwd", units, out_dim, 1, 1, 0))
    assert fake_plans.asked == want
    texts = [str(w.message) for w in seen]
    if refused_by is None:
        assert texts == []
    else:
        assert len(texts) == 1
        assert ("the CUDA layer %s has no launch plan for a bfloat16 layer "
                "of H=%d P=%d" % (refused_by, units, out_dim)) in texts[0]


def test_layer_eligible_asks_no_plan_past_the_shape_rules(fake_plans):
    """Past 512 units, or a backward with H or P not divisible by 4, the
    shape rules refuse before any plan is asked."""
    cuda = torch.device("cuda")
    assert not lstm_kernels.layer_eligible(cuda, 516, 516, False,
                                           torch.float32, False)
    assert not lstm_kernels.layer_eligible(cuda, 6, 8, True, torch.float32,
                                           True)
    assert fake_plans.asked == []


def make_stack(units, out_dim, layers=3, d=10):
    gen = torch.Generator().manual_seed(units)
    cells_ = []
    width = d
    for _ in range(layers):
        cells_.append(cells.init_lstm_cell(gen, width, units, out_dim,
                                           True))
        width = out_dim
    return cells_


@pytest.mark.parametrize("units,out_dim,train,eligible", [
    (8, 4, True, True), (8, 4, False, True), (6, 4, True, False),
    (6, 4, False, True), (8, 6, True, False), (513, 4, False, False),
    (512, 4, True, True)])
def test_stack_eligible_shape_rules(units, out_dim, train, eligible):
    """K13 takes H and P divisible by 4 (training only); K12 and K13 at
    most 512 units."""
    stack = make_stack(units, out_dim)
    assert lstm_stack_kernels.stack_eligible(stack, train) is eligible


class FakeStackPlans:
    """K12's and K13's plan queries, answering from a table of shapes and
    counting the questions; no other entry (no CUDA call) exists."""

    def __init__(self, fwd, bwd):
        self.fwd, self.bwd, self.asked = fwd, bwd, []

    def lstm_stack_fwd_fits(self, units, out_dim, has_proj, bf16):
        self.asked.append(("fwd", units, out_dim, has_proj, bf16))
        return int((units, out_dim) in self.fwd)

    def lstm_stack_bwd_fits(self, units, out_dim, has_proj, bf16,
                            store_bf16):
        self.asked.append(("bwd", units, out_dim, has_proj, bf16,
                           store_bf16))
        return int((units, out_dim) in self.bwd)


@pytest.fixture
def fake_stack_plans(monkeypatch, fresh_warnings):
    plans = FakeStackPlans(fwd={(320, 320), (200, 448)}, bwd={(320, 320)})
    monkeypatch.setattr(lstm_stack_kernels._build, "library", lambda: plans)
    lstm_stack_kernels._unplanned.cache_clear()
    yield plans
    lstm_stack_kernels._unplanned.cache_clear()


@pytest.mark.parametrize("units,out_dim,train,refused_by", [
    (320, 320, True, None), (320, 320, False, None),
    (384, 384, False, "forward (K12)"), (384, 384, True, "forward (K12)"),
    (200, 448, False, None), (200, 448, True, "backward (K13)")])
def test_stack_eligible_asks_the_plans_once_a_shape(fake_stack_plans, units,
                                                    out_dim, train,
                                                    refused_by):
    """On a CUDA device the stack predicate asks K12's plan and, in
    training, K13's (with the compute and store dtypes), once a shape: the
    second question, for a stack of another depth, is answered from the
    cache.  A refusal names the kernel that has no plan and warns once;
    nothing but the two plan queries is called."""
    cuda = torch.device("cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for layers in (3, 2):
            stack = make_stack(units, out_dim, layers=layers)
            got = lstm_stack_kernels.stack_eligible(
                stack, train, warn=True, device=cuda, dtype=torch.bfloat16,
                store_dtype=torch.float32)
            assert got is (refused_by is None)
    want = [("fwd", units, out_dim, 1, 1)]
    if train and refused_by != "forward (K12)":
        want.append(("bwd", units, out_dim, 1, 1, 0))
    assert fake_stack_plans.asked == want
    texts = [str(w.message) for w in seen]
    if refused_by is None:
        assert texts == []
    else:
        assert len(texts) == 1
        assert ("the CUDA stack %s has no launch plan for a bfloat16 stack "
                "of H=%d P=%d" % (refused_by, units, out_dim)) in texts[0]
        assert "layer by layer" in texts[0]


def test_stack_eligible_asks_no_plan_past_the_shape_rules(fake_stack_plans):
    """Past 512 units, a stack that is not uniform, a single layer, a
    backward with H or P not divisible by 4, and any stack on the CPU are
    decided before any plan is asked."""
    cuda = torch.device("cuda")
    bf16 = dict(dtype=torch.bfloat16, store_dtype=torch.bfloat16)
    assert not lstm_stack_kernels.stack_eligible(make_stack(516, 516), False,
                                                 device=cuda, **bf16)
    mixed = make_stack(320, 320)[:2] + make_stack(384, 320)[2:]
    assert not lstm_stack_kernels.stack_eligible(mixed, False, device=cuda,
                                                 **bf16)
    assert not lstm_stack_kernels.stack_eligible(make_stack(320, 320)[:1],
                                                 False, device=cuda, **bf16)
    assert not lstm_stack_kernels.stack_eligible(make_stack(6, 8), True,
                                                 device=cuda, **bf16)
    assert lstm_stack_kernels.stack_eligible(make_stack(384, 384), True,
                                             device="cpu", **bf16)
    assert lstm_stack_kernels.stack_eligible(make_stack(384, 384), True,
                                             **bf16)
    assert fake_stack_plans.asked == []


@pytest.mark.parametrize("units,out_dim,device,eligible,asked", [
    (320, 320, "cuda", True, True), (384, 384, "cuda", False, True),
    (516, 516, "cuda", False, False), (384, 384, "cpu", True, False),
    (516, 516, "cpu", False, False)])
def test_stack_layer_eligible_edges(fake_stack_plans, units, out_dim, device,
                                    eligible, asked):
    """One layer with carried states (streaming, after the stack route
    refused): K12 at most 512 units and, on a CUDA device, with a forward
    plan; the backward is never asked."""
    cell = make_stack(units, out_dim, layers=1)[0]
    assert lstm_stack_kernels.stack_layer_eligible(
        cell, torch.device(device), torch.bfloat16) is eligible
    assert fake_stack_plans.asked == (
        [("fwd", units, out_dim, 1, 1)] if asked else [])


def test_refusals_warn_once_per_reason(fresh_warnings):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert not ctc_kernels.dp_eligible(1100, warn=True)
        assert not ctc_kernels.dp_eligible(2000, warn=True)
        assert not moe_kernels.mix_eligible(640, 136, torch.bfloat16,
                                            warn=True)
        assert not moe_kernels.mix_eligible(1100, 72, torch.float32,
                                            warn=True)
        assert not moe_kernels.mix_eligible(1100, 72, torch.float32,
                                            "kernel", warn=True)
        assert not lstm_kernels.layer_eligible("cpu", 6, 6, False,
                                               torch.float32, True,
                                               warn=True)
        assert ctc_kernels.dp_eligible(1024, warn=True)
        assert not ctc_kernels.dp_eligible(1100)   # no warn: silent
    texts = [str(w.message) for w in seen]
    assert len(texts) == 4, texts
    assert "S=1100" in texts[0] and "plain recursion" in texts[0]
    assert "136 targets" in texts[1] and "1100" in texts[2]
    assert "H=6 P=6" in texts[3]


# --- the routed paths against the reference on the CPU ---

def streaming_case(units=516, out_dim=8, d=6, batch=2, time_steps=5):
    """A 2-layer stack past the kernels' 512 units (layer 1 residual),
    inputs, lengths and carried states, float32."""
    rng = np.random.RandomState(units)
    layers = make_stack(units, out_dim, layers=2, d=d)
    x = torch.from_numpy(rng.randn(batch, time_steps, d).astype(np.float32))
    seq = torch.tensor([time_steps, time_steps - 2])
    states = [(torch.from_numpy(rng.randn(batch, units).astype(np.float32)),
               torch.from_numpy(rng.randn(batch, out_dim).astype(np.float32)))
              for _ in range(2)]
    return layers, x, seq, states


def test_streaming_past_the_kernels_matches_the_stack(fresh_warnings):
    """With carried states (streaming), a stack past 512 units runs layer by
    layer through the plain scan: outputs and final states equal the stack
    reference's (the plain version of K12 on the CPU)."""
    layers, x, seq, states = streaming_case()
    flags = [False, True]
    with torch.no_grad():
        got, got_states = lstm.stack_layers(layers, x, seq, flags,
                                            torch.float32,
                                            initial_states=states)
        ref, ref_states = lstm_stack_kernels.lstm_stack_fused(
            layers, x, seq, lstm.FORGET_BIAS, residual_flags=flags,
            compute_dtype=torch.float32, initial_states=states)
    torch.testing.assert_close(got, ref, **TOL)
    for g, r in zip(got_states, ref_states):
        torch.testing.assert_close(g[0], r[0], **TOL)
        torch.testing.assert_close(g[1], r[1], **TOL)


def long_lattice_case(seed, peak=6.0, time_steps=600, vocab=5, max_u=512):
    """Two rows on a lattice of 2·max_u + 1 positions (1025: past K10/K11's
    1024): labels without adjacent repeats, row 1 with 300 labels in 500
    frames; random logits plus ``peak`` along one alignment of each row's
    labels (each label a frame, a blank after some), as a trained model's
    posteriors peak."""
    rng = np.random.RandomState(seed)
    label_len = np.array([max_u, 300], np.int32)
    seq_len = np.array([time_steps, 500], np.int32)
    labels = np.full((2, max_u), -1, np.int32)
    logits = rng.randn(2, time_steps, vocab).astype(np.float32)
    for b in range(2):
        t = 0
        for u in range(label_len[b]):
            c = rng.randint(0, vocab - 1)
            while u and c == labels[b, u - 1]:
                c = rng.randint(0, vocab - 1)
            labels[b, u] = c
            logits[b, t, c] += peak
            t += 1
            if seq_len[b] - t > label_len[b] - u - 1 and rng.rand() < 0.15:
                logits[b, t, vocab - 1] += peak
                t += 1
    return logits, seq_len, labels, label_len


# the gradient's bound: 1e-5 where the log-likelihoods are those of a
# trained model (row 0's loss ~20); for untrained logits (losses ~700) the
# occupancy exp(alpha + beta - lp - log p) inherits the float32 rounding of
# log-likelihoods near 700, whose step is 6.1e-5: there 1e-4 absolute
@pytest.mark.parametrize("seed,peak,grad_atol", [(0, 6.0, 1e-5),
                                                 (1, 0.0, 1e-4)],
                         ids=["trained", "untrained"])
def test_ctc_past_the_kernels_matches_jax(jref, fresh_warnings, one_thread,
                                          seed, peak, grad_atol):
    """The loss and gradient on a 1025-position lattice (the route's plain
    path) equal the JAX package's CTC on the CPU (rtol = atol = 1e-5; the
    gradient of untrained logits to 1e-4 absolute, above); on the CPU,
    where every path is the plain one, nothing warns."""
    logits, seq_len, labels, label_len = long_lattice_case(seed, peak)
    assert 2 * labels.shape[1] + 1 == 1025
    weights = np.array([1.0, 0.5], np.float32)
    x = torch.from_numpy(logits).requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loss = ctc_loss(x, torch.from_numpy(seq_len),
                        torch.from_numpy(labels), torch.from_numpy(label_len))
        (loss * torch.from_numpy(weights)).sum().backward()
    jnp = jref.jnp
    (_, ref_loss), ref_grad = jref.ctc_value_and_grad(
        *[jnp.asarray(a) for a in (logits, seq_len, labels, label_len,
                                   weights)])
    assert (loss.detach().numpy() > 0).all()       # both rows feasible
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss),
                               **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=grad_atol)


def moe_case(seed, n=30, d=16, e=3, v=136):
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    params = {k: t.numpy() for k, t in moe.init_moe(gen, d, v, e).items()}
    params["b_expert"] = (0.1 * rng.randn(e * v)).astype(np.float32)
    params["b_prior"] = (0.1 * rng.randn(e)).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    gout = rng.randn(n, v).astype(np.float32)
    return params, x, gout


def test_moe_past_the_kernels_matches_jax(jref):
    """A head of 136 targets an expert (past the kernels' 128) takes the
    plain mix under autograd; its output and the gradients of x and every
    weight equal the JAX package's head on the CPU (keep 1.0)."""
    params, x, gout = moe_case(3)
    e = 3
    leaves = {k: torch.from_numpy(a).requires_grad_()
              for k, a in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = moe.apply_moe(leaves, xt, e, 10.0)
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()),
                                torch.from_numpy(gout))
    jnp = jref.jnp
    names = list(params)

    def head(xj, *ws):
        return jref.moe.apply_moe(dict(zip(names, ws)), xj, e, 10.0,
                                  compute_dtype=jnp.float32)

    @jref.jax.jit
    def head_and_grads(g, *jargs):
        out, vjp = jref.jax.vjp(head, *jargs)
        return out, vjp(g)

    jargs = [jnp.asarray(x)] + [jnp.asarray(params[k]) for k in names]
    ref_out, ref_grads = head_and_grads(jnp.asarray(gout), *jargs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# --- each refused shape on the card ---

def counted(*wrappers):
    return [w.launches for w in wrappers]


def ratio(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


@pytest.mark.cuda
def test_ctc_route_on_gpu(cuda, fresh_warnings):
    """A 1100-position lattice on CUDA tensors: the plain recursions (loss
    and gradient as on the CPU, test_loss_on_gpu_matches_cpu's bounds), one
    warning, no K10 or K11 launch."""
    logits, seq_len, labels, label_len = long_lattice_case(
        2, time_steps=600, max_u=550)
    assert labels.shape[1] == 550
    args = [torch.from_numpy(a) for a in (seq_len, labels, label_len)]
    x = torch.from_numpy(logits).requires_grad_()
    ctc_loss(x, *args).sum().backward()
    wrappers = (ctc_kernels.ctc_alpha, ctc_kernels.ctc_beta)
    before = counted(*wrappers)
    xg = torch.from_numpy(logits).to(cuda).requires_grad_()
    with pytest.warns(UserWarning, match="S=1101"):
        loss = ctc_loss(xg, *[a.to(cuda) for a in args])
        loss.sum().backward()
    torch.cuda.synchronize()
    assert counted(*wrappers) == before
    np.testing.assert_allclose(loss.detach().cpu().numpy(),
                               ctc_loss(x.detach(), *args).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xg.grad.cpu().numpy(), x.grad.numpy(),
                               rtol=1e-4, atol=1e-4)


MOE_WRAPPERS = (moe_kernels.moe_mix_forward, moe_kernels.moe_mix_forward_stash,
                moe_kernels.moe_mix_backward,
                moe_kernels.moe_mix_backward_noemit, moe_kernels.moe_mix_wgrad,
                moe_kernels.moe_mix_backward_wgrad)


@pytest.mark.cuda
@pytest.mark.parametrize("d,v,dtype,match", [
    (64, 136, torch.bfloat16, "136 targets"),
    (1100, 72, torch.float32, "input width of 1100")])
def test_moe_route_on_gpu(cuda, fresh_warnings, d, v, dtype, match):
    """A head past the kernels (V = 136; float32 at D = 1100) in training on
    the card: the plain mix under autograd, equal to the plain version on
    the same tensors, one warning, no launch of K4-K9."""
    params, x, gout = moe_case(4, n=200, d=d, e=4, v=v)
    leaves = {k: torch.from_numpy(a).to(cuda).requires_grad_()
              for k, a in params.items()}
    xt = torch.from_numpy(x).to(cuda).requires_grad_()
    gen = torch.Generator(cuda).manual_seed(0)
    before = counted(*MOE_WRAPPERS)
    with pytest.warns(UserWarning, match=match):
        out = moe.apply_moe(leaves, xt, 4, 10.0, compute_dtype=dtype,
                            keep_prob=0.9, generator=gen,
                            wgrad_mode="twokernel")
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()),
                                torch.from_numpy(gout).to(cuda))
    torch.cuda.synchronize()
    assert counted(*MOE_WRAPPERS) == before
    # the same draws again, through the plain version itself
    gen = torch.Generator(cuda).manual_seed(0)
    gate = torch.softmax(xt @ leaves["w_prior"] + leaves["b_prior"], -1)
    gate = cells.dropout(gen, gate, 0.9)
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                         device=cuda, dtype=torch.int32)
    ref = moe_kernels.moe_mix_reference(
        xt, leaves["w_expert"], leaves["b_expert"], gate, 4, 10.0, 0.9,
        seed, dtype)
    ref_grads = torch.autograd.grad(ref, [xt] + list(leaves.values()),
                                    torch.from_numpy(gout).to(cuda))
    assert torch.equal(out, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_streaming_route_on_gpu(cuda, fresh_warnings):
    """A stack past 512 units with carried states on the card: the plain
    scan, as on the CPU, one warning, no K12 launch."""
    layers, x, seq, states = streaming_case()
    flags = [False, True]
    with torch.no_grad():
        ref, ref_states = lstm.stack_layers(layers, x, seq, flags,
                                            torch.float32,
                                            initial_states=states)
        before = lstm_stack_kernels.lstm_stack_forward.launches
        with pytest.warns(UserWarning, match="516 units"):
            got, got_states = lstm.stack_layers(
                [{k: t.to(cuda) for k, t in c.items()} for c in layers],
                x.to(cuda), seq.to(cuda), flags, torch.float32,
                initial_states=[(c.to(cuda), h.to(cuda))
                                for c, h in states])
        torch.cuda.synchronize()
    assert lstm_stack_kernels.lstm_stack_forward.launches == before
    assert ratio(got.cpu(), ref) <= 1e-4
    for g, r in zip(got_states, ref_states):
        assert ratio(g[0].cpu(), r[0]) <= 1e-4
        assert ratio(g[1].cpu(), r[1]) <= 1e-4


@pytest.mark.cuda
def test_blstm_route_on_gpu(cuda, fresh_warnings):
    """A bf16 BLSTM layer of H = P = 384 in training, for which K1 has no
    launch plan (its gate product needs more warps than a block has within
    the products' bounds; K2's weight slices would not fit shared memory
    either): the plain recurrence under autograd, equal to
    cells.bilstm_dual_scan on the same tensors, one warning, no K1, K2 or
    K3 launch."""
    config = {"nnet_type": "blstm", "input_dim": 20, "num_layers": 1,
              "num_neurons": 384, "num_projects": 384, "num_targets": 9,
              "use_peepholes": True, "compute_dtype": "bfloat16"}
    gen = torch.Generator().manual_seed(5)
    params = blstm.init_blstm(gen, config, cuda)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 17, 20).astype(np.float32)).to(cuda)
    seq = torch.tensor([17, 9, 12], device=cuda)
    leaves = [t.requires_grad_() for t in params["fwd"][0].values()]
    wrappers = (lstm_kernels.lstm_layer_forward,
                lstm_kernels.lstm_layer_backward,
                lstm_kernels.lstm_layer_backward_fold)
    before = counted(*wrappers)
    with pytest.warns(UserWarning,
                      match=r"forward \(K1\) has no launch plan for a "
                      "bfloat16 layer of H=384 P=384"):
        logits, _, _ = blstm.apply_blstm(params, x, seq, config, train=True)
    grads = torch.autograd.grad(logits.sum(), leaves)
    torch.cuda.synchronize()
    assert counted(*wrappers) == before
    rev = cells.reverse_sequence(x, seq)
    fw, bw, _ = cells.bilstm_dual_scan(params["fwd"][0], params["bwd"][0], x,
                                       rev, seq, blstm.FORGET_BIAS,
                                       compute_dtype=torch.bfloat16)
    cat = torch.cat([fw, cells.reverse_sequence(bw, seq)], dim=2)
    ref = (cat.reshape(-1, 768) @ params["head"]["w"]
           + params["head"]["b"]).reshape(3, 17, 9)
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    assert torch.equal(logits, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("units,out_dim,dtype", [
    (320, 320, torch.bfloat16), (384, 384, torch.bfloat16),
    (200, 448, torch.bfloat16), (324, 324, torch.bfloat16),
    (384, 384, torch.float32), (512, 512, torch.float32),
    (64, 640, torch.float32)],
    ids=["bf16-320", "bf16-384", "bf16-200x448", "bf16-324", "f32-384",
         "f32-512", "f32-64x640"])
def test_layer_eligible_agrees_with_the_launchers_on_gpu(cuda, units,
                                                         out_dim, dtype):
    """The predicate's plans are the launchers' own: where it takes a
    layer, K1 launches and K2's launch plan is found; where it refuses,
    K1's wrapper and K2's plan query raise.  B = 3, 64 and 512 reach K1's
    launches of all clusters at once and in waves; at P = 640 in float32
    R = 8 has no plan, so the waves run with R = 6."""
    forward = lstm_kernels.layer_eligible(cuda, units, out_dim, True, dtype,
                                          False)
    backward = lstm_kernels.layer_eligible(cuda, units, out_dim, True,
                                           dtype, True, dtype)
    gen = torch.Generator().manual_seed(units)
    wh = (torch.randn(2, out_dim, 4 * units, generator=gen) * 0.05).to(
        cuda, dtype)
    proj = (torch.randn(2, units, out_dim, generator=gen) * 0.05).to(
        cuda, dtype)
    for batch in (3, 64, 512):
        gx = torch.randn(5, 2 * batch, 4 * units, generator=gen).to(cuda)
        seq = torch.full((batch,), 5, dtype=torch.int32)

        def run():
            out = lstm_kernels.lstm_layer_forward(gx, seq, None, wh, proj,
                                                  None, 1.0)[0]
            torch.cuda.synchronize()
            return out

        if forward:
            assert torch.isfinite(run()).all()
        else:
            with pytest.raises(RuntimeError, match="lstm_fwd"):
                run()
        if backward:
            assert lstm_kernels.backward_config(cuda, batch, units, out_dim,
                                                True, dtype)["rows"] > 0
        else:
            with pytest.raises(RuntimeError, match="lstm_bwd_config"):
                lstm_kernels.backward_config(cuda, batch, units, out_dim,
                                             True, dtype)


# the stack shapes held against the launchers on the card: the flagship
# lstm width, the widths past it up to K12/K13's 512 units, a narrow H
# under a wide P, and float32
STACK_SHAPES = [(320, 320, torch.bfloat16), (384, 384, torch.bfloat16),
                (448, 448, torch.bfloat16), (512, 512, torch.bfloat16),
                (200, 448, torch.bfloat16), (384, 384, torch.float32),
                (512, 512, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("units,out_dim,dtype", STACK_SHAPES,
                         ids=["bf16-320", "bf16-384", "bf16-448", "bf16-512",
                              "bf16-200x448", "f32-384", "f32-512"])
def test_stack_eligible_agrees_with_the_launchers_on_gpu(cuda, units,
                                                         out_dim, dtype):
    """The stack predicate's plans are the launchers' own, and depend on
    the shape alone: at B = 3, 64 and 512 (one row tile, and waves of
    them), where it takes a 4-layer stack K12's (in training also K13's)
    launch plan is found, and where it refuses the launcher's plan query
    raises.  The answers are printed for the record."""
    stack = make_stack(units, out_dim, layers=4, d=out_dim + 8)
    forward = lstm_stack_kernels.stack_eligible(stack, False, device=cuda,
                                                dtype=dtype)
    backward = lstm_stack_kernels.stack_eligible(
        stack, True, device=cuda, dtype=dtype, store_dtype=torch.bfloat16)
    print("stack H=%d P=%d %s: forward %s, training %s"
          % (units, out_dim, dtype, forward, backward))
    for batch in (3, 64, 512):
        for train, eligible in ((False, forward), (True, backward)):
            if train and not forward:
                continue  # the forward's refusal decides first

            def plan():
                return lstm_stack_kernels.stack_config(
                    cuda, 40, 4, batch, units, out_dim, True, dtype,
                    backward=train, store_dtype=torch.bfloat16)

            if eligible:
                assert plan()["rows"] > 0
            else:
                with pytest.raises(RuntimeError,
                                   match="lstm_stack_%s_config"
                                   % ("bwd" if train else "fwd")):
                    plan()


def refused_stack_case(cuda, layers=3, d=20, batch=3, time_steps=17):
    """A bf16 lstm stack of H = P = 384 (layer 0 fed D = 20, the others
    residual) on the card, its inputs and lengths."""
    rng = np.random.RandomState(384)
    stack = [{k: t.to(cuda) for k, t in c.items()}
             for c in make_stack(384, 384, layers=layers, d=d)]
    x = torch.from_numpy(rng.randn(batch, time_steps, d).astype(
        np.float32)).to(cuda)
    seq = torch.tensor([time_steps, 9, 12], device=cuda)
    return stack, x, seq, [False] + [True] * (layers - 1)


@pytest.mark.cuda
def test_stack_route_on_gpu(cuda, fresh_warnings):
    """A bf16 lstm stack of H = P = 384 in training, for which K12 has no
    launch plan (its weight slices and input stage exceed a block's shared
    memory, as K1's do): the stack runs layer by layer (there K1 refuses
    too: the plain recurrence under autograd), equal bit for bit to that
    composition on the same tensors, with the stack's warning and no K12,
    K13, K1 or K2 launch."""
    stack, x, seq, flags = refused_stack_case(cuda)
    leaves = [t.requires_grad_() for c in stack for t in c.values()]
    wrappers = (lstm_stack_kernels.lstm_stack_forward,
                lstm_stack_kernels.lstm_stack_backward,
                lstm_kernels.lstm_layer_forward,
                lstm_kernels.lstm_layer_backward)
    before = counted(*wrappers)
    with pytest.warns(UserWarning,
                      match=r"stack forward \(K12\) has no launch plan for a "
                      "bfloat16 stack of H=384 P=384"):
        got, _ = lstm.stack_layers(stack, x, seq, flags, torch.bfloat16)
    grads = torch.autograd.grad(got.sum(), leaves)
    torch.cuda.synchronize()
    assert counted(*wrappers) == before
    ref = x
    for cell, residual in zip(stack, flags):
        out = lstm.layer_forward(cell, ref, seq, torch.bfloat16)
        ref = out + ref if residual else out
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_stack_streaming_route_on_gpu(cuda, fresh_warnings):
    """The same stack with carried states (streaming): each layer through
    the plain scan, since K12 has no plan for one layer of it either; equal
    bit for bit to that composition, no K12 launch."""
    stack, x, seq, flags = refused_stack_case(cuda)
    rng = np.random.RandomState(5)
    states = [tuple(torch.from_numpy(rng.randn(3, 384).astype(
        np.float32)).to(cuda) for _ in range(2)) for _ in stack]
    before = lstm_stack_kernels.lstm_stack_forward.launches
    with torch.no_grad():
        with pytest.warns(UserWarning, match=r"stack forward \(K12\)"):
            got, got_states = lstm.stack_layers(stack, x, seq, flags,
                                                torch.bfloat16,
                                                initial_states=states)
        ref, ref_states = x, []
        for cell, residual, state in zip(stack, flags, states):
            out, st = cells.lstm_scan(cell, ref, seq, lstm.FORGET_BIAS,
                                      state, torch.bfloat16)
            ref = out + ref if residual else out
            ref_states.append(st)
    torch.cuda.synchronize()
    assert lstm_stack_kernels.lstm_stack_forward.launches == before
    assert torch.equal(got, ref)
    for g, r in zip(got_states, ref_states):
        assert torch.equal(g[0], r[0]) and torch.equal(g[1], r[1])
