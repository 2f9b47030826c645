"""The routes that send a shape the kernels refuse to the plain versions,
decided from the shapes before any launch, as the reference does: the
predicates ``ctc_kernels.dp_eligible``, ``moe_kernels.mix_eligible``,
``lstm_kernels.layer_eligible`` and ``lstm_stack_kernels.stack_eligible``
at their edges, one warning per process per reason, and the routed paths
against the JAX package on the CPU (a CTC lattice past 1024 positions, a
MoE head of 136 targets under the twokernel backward, whose K8 and K9 take
V <= 128) at rtol = atol = 1e-5.  The ``cuda`` tests run
each refused shape on the card: equal to the plain version at the
existing bounds, one warning, and no kernel launch.  JAX is imported by a
fixture, so the ``cuda`` tests also run where JAX is not installed.
"""

import math
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
                                 (1025, 129), (1024, 136), (1025, 136),
                                 (640, 4096), (1100, 4096), (640, 4097),
                                 (640, 200), (640, 127)])
def test_mix_eligible_edges(d, v, dtype, mode):
    # "xla" (K4-K6): V <= 128, or lcm(V, 128) <= 4096 as the reference's
    # fused_eligible (129: lcm 16512, refused; 136: 2176; 200: 3200; 4097:
    # past 4096); "twokernel" and "kernel" (K7-K9): V <= 128; D <= 1024 for
    # the float32 bodies only
    wide = v * 128 // math.gcd(v, 128) <= 4096
    want = ((v <= 128 or (wide and mode == "xla"))
            and (d <= 1024 or dtype == torch.bfloat16))
    assert moe_kernels.mix_eligible(d, v, dtype, mode) is want


def test_mix_eligible_refuses_unknown_modes():
    with pytest.raises(ValueError, match="wgrad_mode"):
        moe_kernels.mix_eligible(640, 72, torch.bfloat16, "fused")


@pytest.mark.parametrize("units,out_dim,train,eligible", [
    (512, 512, True, True), (513, 512, False, True), (513, 4, True, False),
    (1024, 1024, True, True), (1025, 1024, False, True),
    (1025, 4, True, False), (1024, 256, True, True),
    (320, 320, True, True), (6, 8, True, False), (8, 6, True, False),
    (6, 6, False, True), (10, 320, True, False), (2048, 2048, True, True),
    (2048, 512, True, True), (2049, 2048, False, False),
    (2049, 4, True, False), (2052, 512, True, False)])
def test_layer_eligible_shape_edges(units, out_dim, train, eligible):
    """The shape-only part (a CPU device asks the library nothing): at most
    2048 units (16 blocks of 128); in training H and P divisible by 4 (6
    and 10 are 2 mod 4)."""
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
    """Past 2048 units, or a backward with H or P not divisible by 4, the
    shape rules refuse before any plan is asked."""
    cuda = torch.device("cuda")
    assert not lstm_kernels.layer_eligible(cuda, 2052, 2052, False,
                                           torch.float32, False)
    assert not lstm_kernels.layer_eligible(cuda, 6, 8, True, torch.float32,
                                           True)
    assert fake_plans.asked == []


# the widths past the 8-block plans that the 16-block ones take: Kaldi's
# BLSTMP cell and projection (1024, 256), and H = P = 512 and 384; and the
# streamed plan's: H = P = 1024 (no projection), 2048 cells with a
# projection of 512 (Sak et al.'s LSTMP)
WIDE = [(1024, 256), (512, 512), (384, 384), (1024, 1024), (2048, 512)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("units,out_dim", WIDE)
def test_layer_eligible_takes_the_wide_shapes(monkeypatch, fresh_warnings,
                                              units, out_dim, train, dtype):
    """Where the plans take a wide layer (the library answers 16, the
    blocks a cluster of its plan, resident or streamed), so does the
    predicate, on a CUDA device, in serving and in training, asking nothing
    but the two plan queries; H = 2049 is refused before any question."""
    plans = FakePlans(fwd=set(WIDE), bwd=set(WIDE))
    plans.lstm_fwd_fits = lambda *a: 16 * FakePlans.lstm_fwd_fits(plans, *a)
    plans.lstm_bwd_fits = lambda *a: 16 * FakePlans.lstm_bwd_fits(plans, *a)
    monkeypatch.setattr(lstm_kernels._build, "library", lambda: plans)
    lstm_kernels._unplanned.cache_clear()
    cuda = torch.device("cuda")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert lstm_kernels.layer_eligible(
                cuda, units, out_dim, out_dim != units, dtype, train, dtype,
                warn=True)
            assert not lstm_kernels.layer_eligible(
                cuda, 2049, out_dim, True, dtype, train, dtype)
    finally:
        lstm_kernels._unplanned.cache_clear()
    bf16 = int(dtype == torch.bfloat16)
    want = [("fwd", units, out_dim, int(out_dim != units), bf16)]
    if train:
        want.append(("bwd", units, out_dim, int(out_dim != units), bf16,
                     bf16))
    assert plans.asked == want


def make_stack(units, out_dim, layers=3, d=10):
    """``layers`` peephole cells of ``units`` (with a projection to
    ``out_dim``, none when it is None), layer 0 fed ``d`` wide."""
    gen = torch.Generator().manual_seed(units)
    cells_ = []
    width = d
    for _ in range(layers):
        cells_.append(cells.init_lstm_cell(gen, width, units, out_dim,
                                           True))
        width = out_dim or units
    return cells_


@pytest.mark.parametrize("units,out_dim,train,eligible", [
    (8, 4, True, True), (8, 4, False, True), (6, 4, True, False),
    (6, 4, False, True), (8, 6, True, False), (1028, 4, False, True),
    (512, 4, True, True), (1024, 4, True, True), (1025, 4, False, True),
    (2052, 4, False, False), (2048, 4, True, True), (2049, 4, False, False),
    (1536, 8, True, True)])
def test_stack_eligible_shape_rules(units, out_dim, train, eligible):
    """K13 takes H and P divisible by 4 (training only); K12 and K13 at
    most 2048 units (16 blocks of 128), as the layer kernels."""
    stack = make_stack(units, out_dim)
    assert lstm_stack_kernels.stack_eligible(stack, train) is eligible


class FakeStackPlans:
    """K12's and K13's plan queries and launch configs, answering from
    tables of shapes and counting the questions; no other entry (no CUDA
    call) exists.  The fits queries answer the blocks a cluster (16 for the
    shapes in ``wide``, -16 for those in ``streamed``, else 8, 0 for none);
    a config answers rows 0 when the clusters the card holds at once
    (``resident``, 14 by default) are fewer than the stack's layers."""

    def __init__(self, fwd, bwd, wide=(), resident=None, streamed=()):
        self.fwd, self.bwd, self.asked = fwd, bwd, []
        self.wide, self.resident = set(wide), dict(resident or {})
        self.streamed = set(streamed)

    def _blocks(self, units, out_dim, table):
        if (units, out_dim) not in table:
            return 0
        if (units, out_dim) in self.streamed:
            return -16
        return 16 if (units, out_dim) in self.wide else 8

    def lstm_stack_fwd_fits(self, units, out_dim, has_proj, bf16):
        self.asked.append(("fwd", units, out_dim, has_proj, bf16))
        return self._blocks(units, out_dim, self.fwd)

    def lstm_stack_bwd_fits(self, units, out_dim, has_proj, bf16,
                            store_bf16):
        self.asked.append(("bwd", units, out_dim, has_proj, bf16,
                           store_bf16))
        return self._blocks(units, out_dim, self.bwd)

    def _config(self, which, table, device, steps, layers, batch, units,
                out_dim, has_proj, bf16, info, scratch):
        self.asked.append((which + " config", units, out_dim, layers))
        blocks = self._blocks(units, out_dim, table)
        held = self.resident.get((units, out_dim), 14)
        rows = 4 if blocks and held >= layers else 0
        for i, v in enumerate((abs(blocks), rows, rows and 1, rows and 1,
                               rows and 1, 2, 1000, held, int(blocks < 0),
                               1000, 0)):
            info[i] = v
        return 0

    def lstm_stack_fwd_config(self, *args):
        return self._config("fwd", self.fwd, *args)

    def lstm_stack_bwd_config(self, *args):
        return self._config("bwd", self.bwd, *(args[:8] + args[9:]))


@pytest.fixture
def fake_stack_plans(monkeypatch, fresh_warnings):
    plans = FakeStackPlans(fwd={(320, 320), (200, 448), (1024, 256),
                                (2048, 512), (1024, 1024)},
                           bwd={(320, 320), (1024, 256), (2048, 512)},
                           wide={(1024, 256)}, resident={(1024, 256): 7},
                           streamed={(2048, 512), (1024, 1024)})
    monkeypatch.setattr(lstm_stack_kernels._build, "library", lambda: plans)
    lstm_stack_kernels._unplanned.cache_clear()
    lstm_stack_kernels._config.cache_clear()
    yield plans
    lstm_stack_kernels._unplanned.cache_clear()
    lstm_stack_kernels._config.cache_clear()


@pytest.mark.parametrize("units,out_dim,train,refused_by", [
    (320, 320, True, None), (320, 320, False, None),
    (384, 384, False, "forward (K12)"), (384, 384, True, "forward (K12)"),
    (200, 448, False, None), (200, 448, True, "backward (K13)"),
    (1024, 256, True, None), (1024, None, False, None),
    (1024, None, True, "backward (K13)"), (2048, 512, True, None),
    (640, None, False, "forward (K12)")])
def test_stack_eligible_asks_the_plans_once_a_shape(fake_stack_plans, units,
                                                    out_dim, train,
                                                    refused_by):
    """On a CUDA device the stack predicate asks K12's plan and, in
    training, K13's (with the compute and store dtypes), once a shape: the
    second question, for a stack of another depth, is answered from the
    cache; then, for each depth, whether the card holds its layers at once
    (the launchers' configs, once a shape and depth).  A refusal names the
    kernel that has no plan and warns once; nothing but the plan queries
    and the configs is called.  The streamed plans (a negative answer) are
    plans: bf16 H = P = 1024 without a projection (8 MB of wh a layer) and
    2048 cells with a projection of 512 take them."""
    cuda = torch.device("cuda")
    has_proj = int(out_dim is not None)
    out_dim = out_dim or units
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for layers in (3, 2):
            stack = make_stack(units, out_dim if has_proj else None,
                               layers=layers)
            got = lstm_stack_kernels.stack_eligible(
                stack, train, warn=True, device=cuda, dtype=torch.bfloat16,
                store_dtype=torch.float32)
            assert got is (refused_by is None)
    want = [("fwd", units, out_dim, has_proj, 1)]
    if train and refused_by != "forward (K12)":
        want.append(("bwd", units, out_dim, has_proj, 1, 0))
    if refused_by is None:
        for layers in (3, 2):
            want.append(("fwd config", units, out_dim, layers))
            if train:
                want.append(("bwd config", units, out_dim, layers))
    assert fake_stack_plans.asked == want
    texts = [str(w.message) for w in seen]
    if refused_by is None:
        assert texts == []
    else:
        assert len(texts) == 1
        assert ("the CUDA stack %s has no launch plan for a bfloat16 stack "
                "of H=%d P=%d" % (refused_by, units, out_dim)) in texts[0]
        assert "layer by layer" in texts[0]


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_stack_eligible_refuses_a_stack_deeper_than_the_card_holds(
        fake_stack_plans, train):
    """A stack whose row tile's L clusters the card cannot hold at once
    (here 7 sixteen-block clusters, a stack of 8 layers of H = 1024, P =
    256) is refused before any launch, with one warning naming the
    resident clusters and the depth; a stack of 7 such layers is taken."""
    cuda = torch.device("cuda")
    bf16 = dict(dtype=torch.bfloat16, store_dtype=torch.bfloat16)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(2):
            assert not lstm_stack_kernels.stack_eligible(
                make_stack(1024, 256, layers=8), train, warn=True,
                device=cuda, **bf16)
        assert lstm_stack_kernels.stack_eligible(
            make_stack(1024, 256, layers=7), train, warn=True, device=cuda,
            **bf16)
    texts = [str(w.message) for w in seen]
    assert len(texts) == 1, texts
    assert ("the card holds 7 clusters of the CUDA stack forward (K12) at "
            "once for a bfloat16 stack of H=1024 P=256, fewer than its 8 "
            "layers") in texts[0]
    assert "layer by layer" in texts[0]
    configs = [a for a in fake_stack_plans.asked if "config" in a[0]]
    assert configs == [("fwd config", 1024, 256, 8), ("fwd config", 1024,
                                                     256, 7)] + (
        [("bwd config", 1024, 256, 7)] if train else [])


def test_stack_eligible_asks_no_plan_past_the_shape_rules(fake_stack_plans):
    """Past 2048 units, a stack that is not uniform, a single layer, a
    backward with H or P not divisible by 4, and any stack on the CPU are
    decided before any plan is asked."""
    cuda = torch.device("cuda")
    bf16 = dict(dtype=torch.bfloat16, store_dtype=torch.bfloat16)
    assert not lstm_stack_kernels.stack_eligible(make_stack(2052, 8),
                                                 False, device=cuda, **bf16)
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
    (2052, 8, "cuda", False, False), (384, 384, "cpu", True, False),
    (2052, 8, "cpu", False, False), (1024, 256, "cuda", True, True),
    (2048, 512, "cuda", True, True), (1028, 8, "cpu", True, False)])
def test_stack_layer_eligible_edges(fake_stack_plans, units, out_dim, device,
                                    eligible, asked):
    """One layer with carried states (streaming, after the stack route
    refused): K12 at most 2048 units and, on a CUDA device, with a forward
    plan, resident or streamed (2048/512); the backward is never asked, nor
    whether one layer is held."""
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
        assert not moe_kernels.mix_eligible(640, 129, torch.bfloat16,
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
    assert "129 targets" in texts[1] and "1100" in texts[2]
    assert "H=6 P=6" in texts[3]


# --- the routed paths against the reference on the CPU ---

def streaming_case(units=2052, out_dim=8, d=6, batch=2, time_steps=5):
    """A 2-layer stack past the kernels' 2048 units (layer 1 residual),
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
    """With carried states (streaming), a stack past 2048 units runs layer by
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
    """A head of 136 targets an expert under ``moe_wgrad_mode =
    twokernel`` (past K8's and K9's 128) takes the plain mix under
    autograd; its output and the gradients of x and every weight equal the
    JAX package's head on the CPU (keep 1.0)."""
    params, x, gout = moe_case(3)
    assert not moe_kernels.mix_eligible(16, 136, torch.float32, "twokernel")
    e = 3
    leaves = {k: torch.from_numpy(a).requires_grad_()
              for k, a in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = moe.apply_moe(leaves, xt, e, 10.0, wgrad_mode="twokernel")
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
    """A head past the kernels of the twokernel backward (V = 136, which
    K8 and K9 refuse; float32 at D = 1100) in training on the card: the
    plain mix under autograd, equal to the plain version on the same
    tensors, one warning, no launch of K4-K9."""
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
    """A stack past 2048 units with carried states on the card: the plain
    scan, as on the CPU, one warning, no K12 launch."""
    layers, x, seq, states = streaming_case()
    flags = [False, True]
    with torch.no_grad():
        ref, ref_states = lstm.stack_layers(layers, x, seq, flags,
                                            torch.float32,
                                            initial_states=states)
        before = lstm_stack_kernels.lstm_stack_forward.launches
        with pytest.warns(UserWarning, match="2052 units"):
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


ROUTED_UNITS = 2052  # past the layer kernels' 2048 units


@pytest.mark.cuda
def test_blstm_route_on_gpu(cuda, fresh_warnings):
    """A bf16 BLSTM layer of H = P = 2052 without a projection in
    training, past the layer kernels' 2048 units (H = P = 1024, which this
    test routed until the streamed plan took it, now runs K1 and K2): the
    plain recurrence under autograd, equal to cells.bilstm_dual_scan on the
    same tensors, one warning, no K1, K2 or K3 launch."""
    config = {"nnet_type": "blstm", "input_dim": 20, "num_layers": 1,
              "num_neurons": ROUTED_UNITS, "num_projects": 0,
              "num_targets": 9, "use_peepholes": True,
              "compute_dtype": "bfloat16"}
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
                      match="a layer of %d units exceeds the CUDA layer "
                      "kernels' 2048" % ROUTED_UNITS):
        logits, _, _ = blstm.apply_blstm(params, x, seq, config, train=True)
    grads = torch.autograd.grad(logits.sum(), leaves)
    torch.cuda.synchronize()
    assert counted(*wrappers) == before
    rev = cells.reverse_sequence(x, seq)
    fw, bw, _ = cells.bilstm_dual_scan(params["fwd"][0], params["bwd"][0], x,
                                       rev, seq, blstm.FORGET_BIAS,
                                       compute_dtype=torch.bfloat16)
    cat = torch.cat([fw, cells.reverse_sequence(bw, seq)], dim=2)
    ref = (cat.reshape(-1, 2 * ROUTED_UNITS) @ params["head"]["w"]
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
    (64, 640, torch.float32), (1024, 256, torch.bfloat16),
    (512, 512, torch.bfloat16), (1024, 256, torch.float32),
    (1024, 1024, torch.bfloat16), (1028, 256, torch.float32),
    (2048, 512, torch.bfloat16), (2048, 512, torch.float32),
    (2052, 256, torch.float32), (2048, 2048, torch.bfloat16),
    (2048, 2048, torch.float32), (2048, None, torch.bfloat16),
    (2048, None, torch.float32)],
    ids=["bf16-320", "bf16-384", "bf16-200x448", "bf16-324", "f32-384",
         "f32-512", "f32-64x640", "bf16-1024x256", "bf16-512",
         "f32-1024x256", "bf16-1024", "f32-1028x256", "bf16-2048x512",
         "f32-2048x512", "f32-2052x256", "bf16-2048x2048", "f32-2048x2048",
         "bf16-2048-noproj", "f32-2048-noproj"])
def test_layer_eligible_agrees_with_the_launchers_on_gpu(cuda, units,
                                                         out_dim, dtype):
    """The predicate's plans are the launchers' own: where it takes a
    layer, K1 launches and K2's launch plan is found; where it refuses,
    K1's wrapper and K2's plan query raise.  B = 3, 64 and 512 reach K1's
    launches of all clusters at once and in waves; at P = 640 in float32
    R = 8 has no plan, so the waves run with R = 6.  The widths past the
    8-block plans run 16-block clusters; bf16 H = P = 1024 (with a
    projection: 1024 x 256 of wh a block), H = 2048, P = 512 and H = P =
    2048 (the widest layer, with and without a projection: out_dim None)
    the streamed plan; H = 2052 has no plan."""
    has_proj = out_dim is not None
    out_dim = out_dim or units
    forward = lstm_kernels.layer_eligible(cuda, units, out_dim, has_proj,
                                          dtype, False)
    backward = lstm_kernels.layer_eligible(cuda, units, out_dim, has_proj,
                                           dtype, True, dtype)
    gen = torch.Generator().manual_seed(units)
    wh = (torch.randn(2, out_dim, 4 * units, generator=gen) * 0.05).to(
        cuda, dtype)
    proj = (torch.randn(2, units, out_dim, generator=gen) * 0.05).to(
        cuda, dtype) if has_proj else None
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
                                                has_proj, dtype)["rows"] > 0
        else:
            with pytest.raises(RuntimeError, match="lstm_bwd_config"):
                lstm_kernels.backward_config(cuda, batch, units, out_dim,
                                             has_proj, dtype)


# the stack shapes held against the launchers on the card: the flagship
# lstm width, the widths past it that take 16-block clusters (Kaldi's LSTMP
# cell and projection, H = P = 384-512 with and without a projection), a
# narrow H under a wide P, float32, the streamed plan's bf16 widths (H = P
# = 768 and 1024 without a projection, Sak's 2048/512, H = P = 2048), the
# same widths in float32 (128 units a block past 1024), and a 16-block
# stack of 8 layers (deeper than the 7 clusters an H100 holds at once);
# (units, out_dim or None, dtype, layers)
STACK_SHAPES = [(320, 320, torch.bfloat16, 4), (384, 384, torch.bfloat16, 4),
                (448, 448, torch.bfloat16, 4), (512, 512, torch.bfloat16, 4),
                (512, None, torch.bfloat16, 4),
                (1024, 256, torch.bfloat16, 4), (200, 448, torch.bfloat16, 4),
                (384, 384, torch.float32, 4), (512, 512, torch.float32, 4),
                (1024, 256, torch.float32, 4),
                (1024, None, torch.bfloat16, 4),
                (384, 384, torch.bfloat16, 8),
                (768, None, torch.bfloat16, 4),
                (2048, 512, torch.bfloat16, 4),
                (2048, 512, torch.float32, 4),
                (2048, None, torch.bfloat16, 4),
                (2048, None, torch.float32, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("units,out_dim,dtype,layers", STACK_SHAPES,
                         ids=["bf16-320", "bf16-384", "bf16-448", "bf16-512",
                              "bf16-512-noproj", "bf16-1024x256",
                              "bf16-200x448", "f32-384", "f32-512",
                              "f32-1024x256", "bf16-1024-noproj",
                              "bf16-384-8layers", "bf16-768-noproj",
                              "bf16-2048x512", "f32-2048x512",
                              "bf16-2048-noproj", "f32-2048-noproj"])
def test_stack_eligible_agrees_with_the_launchers_on_gpu(cuda, units,
                                                         out_dim, dtype,
                                                         layers):
    """The stack predicate's plans are the launchers' own, and depend on
    the shape and the depth alone: at B = 3, 64 and 512 (one row tile, and
    waves of them), where it takes a stack K12's (in training also K13's)
    launch plan is found, of the blocks the fits query answers; where it
    refuses, the launcher's plan query raises (no plan) or answers no rows
    (the card holds fewer clusters at once than the stack has layers).
    The answers are printed for the record."""
    stack = make_stack(units, out_dim, layers=layers,
                       d=(out_dim or units) + 8)
    has_proj = out_dim is not None
    out_dim = out_dim or units
    forward = lstm_stack_kernels.stack_eligible(stack, False, device=cuda,
                                                dtype=dtype)
    backward = lstm_stack_kernels.stack_eligible(
        stack, True, device=cuda, dtype=dtype, store_dtype=torch.bfloat16)
    lib = lstm_stack_kernels._build.library()
    bf16 = int(dtype == torch.bfloat16)
    blocks = {False: lib.lstm_stack_fwd_fits(units, out_dim, int(has_proj),
                                             bf16),
              True: lib.lstm_stack_bwd_fits(units, out_dim, int(has_proj),
                                            bf16, 1)}
    print("stack H=%d P=%d %s x %d: forward %s (%d blocks), training %s "
          "(%d blocks)" % (units, out_dim, dtype, layers, forward,
                           blocks[False], backward, blocks[True]))
    for batch in (3, 64, 512):
        for train, eligible in ((False, forward), (True, backward)):
            if train and not forward:
                continue  # the forward's refusal decides first

            def plan():
                return lstm_stack_kernels.stack_config(
                    cuda, 40, layers, batch, units, out_dim, has_proj, dtype,
                    backward=train, store_dtype=torch.bfloat16)

            if not blocks[train]:
                assert not eligible
                with pytest.raises(RuntimeError,
                                   match="lstm_stack_%s_config"
                                   % ("bwd" if train else "fwd")):
                    plan()
                continue
            how = plan()
            print("  B=%d %s: %s" % (batch, "K13" if train else "K12", how))
            assert how["blocks"] == abs(blocks[train])
            assert how["streamed"] is (blocks[train] < 0)
            assert (how["rows"] > 0) is eligible
            assert (how["resident"] >= layers) is eligible


def refused_stack_case(cuda, units=384, out_dim=384, layers=3, d=20, batch=3,
                       time_steps=17):
    """A bf16 lstm stack (layer 0 fed D = 20, the others residual) on the
    card, its inputs and lengths."""
    rng = np.random.RandomState(units)
    stack = [{k: t.to(cuda) for k, t in c.items()}
             for c in make_stack(units, out_dim, layers=layers, d=d)]
    x = torch.from_numpy(rng.randn(batch, time_steps, d).astype(
        np.float32)).to(cuda)
    seq = torch.tensor([time_steps, 9, 12], device=cuda)
    return stack, x, seq, [False] + [True] * (layers - 1)


@pytest.mark.cuda
def test_stack_route_on_gpu(cuda, fresh_warnings):
    """A bf16 lstm stack of 8 layers of H = P = 384 in training, deeper
    than the sixteen-block clusters an H100 holds at once (7): the stack
    runs layer by layer, through K1 and K2 on 16-block clusters (one launch
    of each a layer), equal bit for bit to that composition on the same
    tensors, with the stack's warning and no K12 or K13 launch."""
    stack, x, seq, flags = refused_stack_case(cuda, layers=8)
    leaves = [t.requires_grad_() for c in stack for t in c.values()]
    wrappers = (lstm_stack_kernels.lstm_stack_forward,
                lstm_stack_kernels.lstm_stack_backward,
                lstm_kernels.lstm_layer_forward,
                lstm_kernels.lstm_layer_backward)
    before = counted(*wrappers)
    with pytest.warns(UserWarning,
                      match=r"clusters of the CUDA stack forward \(K12\) at "
                      "once for a bfloat16 stack of H=384 P=384, fewer than "
                      "its 8 layers"):
        got, _ = lstm.stack_layers(stack, x, seq, flags, torch.bfloat16)
    grads = torch.autograd.grad(got.sum(), leaves)
    torch.cuda.synchronize()
    layers = len(stack)
    assert counted(*wrappers) == [before[0], before[1], before[2] + layers,
                                  before[3] + layers]
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
    """A bf16 stack of H = P = 2052 without a projection with carried
    states (streaming): past the stack kernels' 2048 units, for the stack
    and for one layer of it, so each layer runs the plain scan; equal bit
    for bit to that composition, no K12 launch.  (H = P = 1024, which this
    test routed until the streamed plan took it, now runs K12.)"""
    stack, x, seq, flags = refused_stack_case(cuda, units=ROUTED_UNITS,
                                              out_dim=None, layers=2)
    rng = np.random.RandomState(5)
    states = [tuple(torch.from_numpy(rng.randn(3, ROUTED_UNITS).astype(
        np.float32)).to(cuda) for _ in range(2)) for _ in stack]
    before = lstm_stack_kernels.lstm_stack_forward.launches
    with torch.no_grad():
        with pytest.warns(UserWarning, match="a stack of %d units exceeds "
                          "the CUDA stack kernels' 2048" % ROUTED_UNITS):
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
