"""The port's CTC loss (``ops/ctc``) and its DP kernels (``ops/ctc_kernels``).

On the CPU the alpha/beta wrappers run their plain versions.  The loss and
its gradient are held against the JAX package's ``ctc_loss``, on both its
scan path and its Pallas path in interpret mode (rtol = atol = 1e-5: the
same float32 arithmetic, summed in another order), and against brute-force
enumeration of the alignments on tiny lattices.  The ``cuda`` tests hold
kernels K10 and K11 against their plain versions on the card: finite
entries within 1e-4·max(1, |plain|) and NEG_INF at the same places, and
bit-equal at the lane edges.  JAX is
imported by a fixture, so the ``cuda`` tests also run where JAX is not
installed (pytest --noconftest).
"""

import itertools
import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.host.decode import collapse_ctc
from lstm_ctc_tpu_torch.ops import ctc_kernels
from lstm_ctc_tpu_torch.ops.ctc import _lattice, ctc_loss

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.ops import ctc as jctc
    from lstm_ctc_tpu.ops import ctc_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, ctc=jctc,
                                 pallas=ctc_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def make_case(seed, batch=5, time_steps=16, vocab=6, max_u=5):
    """Random logits and labels with ragged lengths, a repeated-label row,
    an infeasible row (more labels than frames), an empty label and a
    zero-length row."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, time_steps, vocab).astype(np.float32)
    seq_len = rng.randint(time_steps // 2, time_steps + 1,
                          batch).astype(np.int32)
    seq_len[0] = time_steps
    labels = np.full((batch, max_u), -1, np.int32)
    for b in range(batch):
        u = rng.randint(1, max_u + 1)
        labels[b, :u] = rng.randint(0, vocab - 1, u)
    labels[1, :4] = [2, 2, 2, 1]           # repeats: each needs a blank
    seq_len[1] = 6                          # 4 labels + 2 blanks: feasible
    labels[2, :] = rng.randint(0, vocab - 1, max_u)
    seq_len[2] = 3                          # 5 labels in 3 frames
    labels[3, :] = -1                       # empty label
    if batch > 4:
        seq_len[4] = 0                      # padding row
    label_len = (labels >= 0).sum(1).astype(np.int32)
    return logits, seq_len, labels, label_len


def port_loss_and_grad(logits, seq_len, labels, label_len, weights):
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(x, torch.from_numpy(seq_len), torch.from_numpy(labels),
                    torch.from_numpy(label_len))
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def jax_loss_and_grad(jref, logits, seq_len, labels, label_len, weights):
    jnp = jref.jnp
    args = (jnp.asarray(seq_len), jnp.asarray(labels),
            jnp.asarray(label_len))
    loss = jref.ctc.ctc_loss(jnp.asarray(logits), *args)
    grad = jref.jax.grad(lambda lg: jnp.sum(
        jref.ctc.ctc_loss(lg, *args) * jnp.asarray(weights)))(
            jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_grad_match_jax(jref, monkeypatch, impl, seed):
    case = make_case(seed)
    weights = np.random.RandomState(seed + 10).rand(5).astype(np.float32)
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_IMPL", impl)
    ref_loss, ref_grad = jax_loss_and_grad(jref, *case, weights)
    loss, grad = port_loss_and_grad(*case, weights)
    np.testing.assert_allclose(loss, ref_loss, **TOL)
    np.testing.assert_allclose(grad, ref_grad, **TOL)


def test_infeasible_rows_have_zero_loss_and_grad():
    logits, seq_len, labels, label_len = make_case(3)
    loss, grad = port_loss_and_grad(logits, seq_len, labels, label_len,
                                    np.ones(5, np.float32))
    # row 2: more labels than frames; row 4: no frames
    assert loss[2] == 0.0 and loss[4] == 0.0
    assert not grad[2].any() and not grad[4].any()
    # row 1 needs exactly its 6 frames for 4 labels with a repeat run
    assert np.isfinite(loss[1]) and loss[1] > 0.0
    seq_len[1] = 5
    loss, grad = port_loss_and_grad(logits, seq_len, labels, label_len,
                                    np.ones(5, np.float32))
    assert loss[1] == 0.0 and not grad[1].any()
    # frames past each length get no gradient
    for b in range(5):
        assert not grad[b, seq_len[b]:].any()


def brute_force_ctc(log_probs, labels, blank):
    """-log P(labels), enumerating every alignment path; log_probs [T, V]."""
    time_steps, vocab = log_probs.shape
    total = -np.inf
    for path in itertools.product(range(vocab), repeat=time_steps):
        if collapse_ctc(path, blank) == list(labels):
            total = np.logaddexp(total, sum(log_probs[t, path[t]]
                                            for t in range(time_steps)))
    return -total


@pytest.mark.parametrize("labels", [[0], [1, 0], [0, 0], [2, 1, 2], []])
def test_loss_matches_brute_force(labels):
    rng = np.random.RandomState(len(labels))
    time_steps, vocab = 5, 4
    logits = rng.randn(1, time_steps, vocab).astype(np.float32)
    log_probs = torch.log_softmax(torch.from_numpy(logits[0]).double(),
                                  -1).numpy()
    padded = np.full((1, 4), -1, np.int32)
    padded[0, :len(labels)] = labels
    loss = ctc_loss(torch.from_numpy(logits), torch.tensor([time_steps]),
                    torch.from_numpy(padded))
    np.testing.assert_allclose(float(loss[0]),
                               brute_force_ctc(log_probs, labels, vocab - 1),
                               rtol=1e-5)


def test_zero_column_labels_match_jax(jref):
    """Every reference empty and no label column: loss = -Σ_t log P(blank)
    and its gradient, through autograd (``ctc.py`` :372-382)."""
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 7, 5).astype(np.float32)
    seq_len = np.array([7, 4, 0], np.int32)
    labels = np.zeros((3, 0), np.int32)
    label_len = np.zeros(3, np.int32)
    weights = np.array([1.0, 2.0, 3.0], np.float32)
    ref_loss, ref_grad = jax_loss_and_grad(jref, logits, seq_len, labels,
                                           label_len, weights)
    loss, grad = port_loss_and_grad(logits, seq_len, labels, label_len,
                                    weights)
    np.testing.assert_allclose(loss, ref_loss, **TOL)
    np.testing.assert_allclose(grad, ref_grad, **TOL)


def dp_inputs(seed, slots=5, time_steps=19, vocab=6, max_u=5,
              device="cpu"):
    """The alpha and beta kernels' arguments, as ``ops/ctc`` builds them."""
    logits, seq_len, labels, label_len = make_case(seed, slots, time_steps,
                                                   vocab, max_u)
    labels_t = torch.from_numpy(labels)
    lengths = torch.from_numpy(label_len).long()
    ext, valid, can_skip = _lattice(labels_t, lengths, vocab - 1)
    log_probs = torch.log_softmax(torch.from_numpy(logits), -1)
    lp_ext = torch.gather(log_probs, 2, ext[:, None, :].expand(
        -1, time_steps, -1)).transpose(0, 1).contiguous()
    s = torch.arange(ext.shape[1])[None, :]
    init = (s == 0) | ((s == 1) & (lengths[:, None] > 0))
    alpha0 = torch.where(init & valid, lp_ext[0],
                         torch.full_like(lp_ext[0], ctc_kernels.NEG_INF))
    seq = torch.from_numpy(seq_len).long()
    time_mask = torch.arange(time_steps)[:, None] < seq[None, :]
    end = 2 * lengths[:, None]
    final = ((s == end) | ((s == end - 1) & (lengths[:, None] > 0))) & valid
    skip_from = torch.cat([can_skip[:, 2:],
                           torch.zeros_like(can_skip[:, :2])], 1)
    is_last = torch.arange(time_steps)[:, None] == (seq - 1)[None, :]
    alpha = [lp_ext, time_mask, valid, can_skip, alpha0]
    beta = [lp_ext, time_mask, is_last, valid, skip_from, final]
    move = [t.to(device).contiguous() for t in alpha + beta]
    return move[:5], move[5:]


@pytest.mark.parametrize("seed", [0, 4])
def test_dp_plain_matches_jax_pallas_interpret(jref, seed):
    alpha_args, beta_args = dp_inputs(seed)
    jnp = jref.jnp
    alpha = ctc_kernels.ctc_alpha(*alpha_args)
    beta = ctc_kernels.ctc_beta(*beta_args)
    ref_alpha = jref.pallas.alpha_pallas(
        *[jnp.asarray(t.numpy()) for t in alpha_args], interpret=True,
        time_block=8)
    ref_beta = jref.pallas.beta_pallas(
        *[jnp.asarray(t.numpy()) for t in beta_args], interpret=True,
        time_block=8)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha), **TOL)
    np.testing.assert_allclose(beta.numpy(), np.asarray(ref_beta), **TOL)


def test_dp_wrappers_refuse_other_devices():
    alpha_args, beta_args = dp_inputs(1)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_kernels.ctc_alpha(*[t.to("meta") for t in alpha_args])
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_kernels.ctc_beta(*[t.to("meta") for t in beta_args])


def assert_dp_close(got, ref):
    """Finite entries within 1e-4·max(1, |plain|), NEG_INF at the same
    places (K10/K11's bound, PERF.md)."""
    neg = ref <= ctc_kernels.NEG_INF * 0.5
    assert torch.equal(got <= ctc_kernels.NEG_INF * 0.5, neg)
    diff = (got - ref).abs()[~neg]
    assert bool((diff <= 1e-4 * ref.abs()[~neg].clamp(min=1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 4])
def test_dp_kernels_match_plain_on_gpu(cuda, seed):
    alpha_args, beta_args = dp_inputs(seed, slots=7, time_steps=40,
                                      max_u=9, device=cuda)
    before = (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta.launches)
    alpha = ctc_kernels.ctc_alpha(*alpha_args)
    beta = ctc_kernels.ctc_beta(*beta_args)
    torch.cuda.synchronize()
    assert (ctc_kernels.ctc_alpha.launches,
            ctc_kernels.ctc_beta.launches) == (before[0] + 1, before[1] + 1)
    assert_dp_close(alpha, ctc_kernels.alpha_reference(*alpha_args))
    assert_dp_close(beta, ctc_kernels.beta_reference(*beta_args))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 31, 32, 33, 64, 301, 1024])
def test_alpha_kernel_lane_edges_on_gpu(cuda, width):
    """K10 on widths that end inside, at and past a warp's 32 lanes, with
    valid, can_skip and time_mask patterns that cross lane and 32-step
    word boundaries: bit-equal to the plain version."""
    from test_torch_ctc_alpha_lanes import lattice_inputs
    args = [t.to(cuda) for t in lattice_inputs(width)]
    before = ctc_kernels.ctc_alpha.launches
    got = ctc_kernels.ctc_alpha(*args)
    ref = ctc_kernels.alpha_reference(*args)
    torch.cuda.synchronize()
    assert ctc_kernels.ctc_alpha.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 31, 32, 33, 64, 301, 1024])
def test_beta_kernel_lane_edges_on_gpu(cuda, width):
    """K11 on widths that end inside, at and past a warp's 32 lanes, with
    resets several times a row at and across 32-step words, and valid,
    skip_from and time_mask patterns that cross lane and word boundaries:
    bit-equal to the plain version."""
    from test_torch_ctc_beta_lanes import lattice_inputs
    args = [t.to(cuda) for t in lattice_inputs(width)]
    before = ctc_kernels.ctc_beta.launches
    got = ctc_kernels.ctc_beta(*args)
    ref = ctc_kernels.beta_reference(*args)
    torch.cuda.synchronize()
    assert ctc_kernels.ctc_beta.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_loss_on_gpu_matches_cpu(cuda):
    logits, seq_len, labels, label_len = make_case(6)
    weights = np.ones(5, np.float32)
    loss, grad = port_loss_and_grad(logits, seq_len, labels, label_len,
                                    weights)
    x = torch.from_numpy(logits).to(cuda).requires_grad_()
    got = ctc_loss(x, torch.from_numpy(seq_len).to(cuda),
                   torch.from_numpy(labels).to(cuda),
                   torch.from_numpy(label_len).to(cuda))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().cpu().numpy(), loss, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x.grad.cpu().numpy(), grad, rtol=1e-4,
                               atol=1e-4)
