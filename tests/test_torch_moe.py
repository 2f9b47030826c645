"""The MoE head of the port: hash dropout, the expert-mix wrapper, the head.

``hash_uniform`` must equal the JAX package's bit for bit.  The plain
expert mix (``moe_mix_reference``) is held against the JAX fused Pallas
kernel in interpret mode at keep 1.0 and at keep 0.9 with the same seed
(f32, rtol = atol = 1e-5).  The ``cuda`` tests hold kernel B against its
plain version on the card; they skip without a GPU.  JAX is imported by a
fixture, so the ``cuda`` tests also run where JAX is not installed.
"""

import types

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import moe
from lstm_ctc_tpu_torch.ops import moe_kernels
from lstm_ctc_tpu_torch.train.checkpoint import params_from_numpy


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lstm_ctc_tpu.models import moe as jmoe
    from lstm_ctc_tpu.ops import moe_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jmoe,
                                 pallas=moe_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(seed, n=20, d=24, e=5, v=7):
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe(gen, d, v, e)
    x = rng.randn(n, d).astype(np.float32)
    b = (0.1 * rng.randn(e * v)).astype(np.float32)
    logits = rng.randn(n, e).astype(np.float32)
    gate = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return x, params["w_expert"].numpy(), b, gate.astype(np.float32)


@pytest.mark.parametrize("seed,row0,col0,nrows,ncols", [
    (0, 0, 0, 9, 13), (-7, 5, 3, 4, 70), (2 ** 31 - 1, 1000, 64, 3, 5),
    (-2 ** 31, 2 ** 31 - 4, 2 ** 31 - 8, 3, 7), (123457, 0, 0, 1, 1)])
def test_hash_uniform_bit_exact(jref, seed, row0, col0, nrows, ncols):
    ref = jref.pallas.hash_uniform(jref.jnp.int32(seed), row0, col0, nrows,
                                   ncols)
    got = moe_kernels.hash_uniform(seed, row0, col0, nrows, ncols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("e,v,keep_prob", [(5, 7, 1.0), (5, 7, 0.9),
                                           (3, 16, 0.9), (8, 16, 1.0)])
def test_reference_matches_jax_fused_interpret(jref, e, v, keep_prob):
    x, w, b, gate = make_case(1, e=e, v=v)
    seed = -31337
    jnp = jref.jnp
    ref = jref.pallas.moe_mix_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(gate),
        e, 10.0, keep_prob=keep_prob, seed=jnp.int32(seed),
        compute_dtype=jnp.float32, n_block=8, interpret=True)
    got = moe_kernels.moe_mix_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(gate), e, 10.0, keep_prob=keep_prob, seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # the wrapper's CPU path is the plain version
    cpu = moe_kernels.moe_mix_fused(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(gate), e, 10.0, keep_prob=keep_prob, seed=seed,
        compute_dtype=torch.float32)
    assert torch.equal(cpu, got)


@pytest.mark.parametrize("e,v", [(5, 7), (3, 72)])
def test_apply_moe_matches_jax(jref, e, v):
    d, n = 16, 30
    jparams = jref.moe.init_moe(jref.jax.random.PRNGKey(e), d, v, e)
    rng = np.random.RandomState(e)
    x = rng.randn(n, d).astype(np.float32)
    ref = jref.moe.apply_moe(jparams, jref.jnp.asarray(x), e, 10.0)
    params = params_from_numpy(jref.jax.tree.map(np.asarray, jparams))
    got = moe.apply_moe(params, torch.from_numpy(x), e, 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_reference_bf16_rounds_operands_only():
    x, w, b, gate = make_case(2)
    args = [torch.from_numpy(a) for a in (x, w, b, gate)]
    f32 = moe_kernels.moe_mix_reference(*args[:4], 5, 10.0)
    bf16 = moe_kernels.moe_mix_reference(*args[:4], 5, 10.0,
                                         compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    assert 0.0 < float((bf16 - f32).abs().max()) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,e,v,keep_prob", [
    (torch.float32, 5, 7, 1.0), (torch.float32, 6, 16, 0.9),
    (torch.bfloat16, 5, 7, 0.9), (torch.bfloat16, 6, 16, 1.0),
    (torch.bfloat16, 4, 72, 0.9)])
def test_kernel_matches_plain_on_gpu(cuda, dtype, e, v, keep_prob):
    x, w, b, gate = make_case(3, n=150, d=40, e=e, v=v)
    args = [torch.from_numpy(a).to(cuda) for a in (x, w, b, gate)]
    before = moe_kernels.moe_mix_forward.launches
    got = moe_kernels.moe_mix_fused(*args, e, 10.0, keep_prob, 99, dtype)
    ref = moe_kernels.moe_mix_reference(*args, e, 10.0, keep_prob, 99, dtype)
    torch.cuda.synchronize()
    assert moe_kernels.moe_mix_forward.launches == before + 1
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-4 * float(ref.abs().max())
    else:
        assert err <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 150, 1100])
@pytest.mark.parametrize("e,v,d", [(1, 8, 40), (1, 128, 40), (4, 8, 37),
                                   (3, 128, 1000), (3, 72, 1408),
                                   (3, 128, 1408), (3, 72, 1600),
                                   (3, 128, 1600)])
def test_kernel_edge_shapes_on_gpu(cuda, n, e, v, d):
    """bf16 K4 at ragged row counts (one row, a tile less or more one, an
    odd number of tiles), one expert, V at the narrowest and widest
    products, an odd D, a D of 16 chunks, and D whose x tile leaves too
    little shared memory for two W stages, so that x streams with W."""
    x, w, b, gate = make_case(4, n=n, d=d, e=e, v=v)
    args = [torch.from_numpy(a).to(cuda) for a in (x, w, b, gate)]
    for keep_prob in (1.0, 0.9):
        before = moe_kernels.moe_mix_forward.launches
        got = moe_kernels.moe_mix_fused(*args, e, 10.0, keep_prob, 7,
                                        torch.bfloat16)
        ref = moe_kernels.moe_mix_reference(*args, e, 10.0, keep_prob, 7,
                                            torch.bfloat16)
        torch.cuda.synchronize()
        assert moe_kernels.moe_mix_forward.launches == before + 1
        assert got.shape == (n, v) and bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= 5e-2
