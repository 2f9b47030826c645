"""Data parallelism over ``torch.distributed`` (``lstm_ctc_tpu_torch/
parallel/mesh.py``) on the CPU: two gloo ranks in two processes.

Every case trains 2 adam steps (float32, keep 1.0, tiny widths: 2 layers,
16 units, 4 experts, T <= 32) with each rank on its rows of the batch; its
loss, ``size`` and parameters must equal the 1-process step's on the
global batch (rtol = atol = 1e-5) and the JAX package's train step on a
2-device mesh of the conftest's CPU devices (1e-4), and the ranks' weights
must be equal.  The cases: a dense-head BLSTM, the MoE head, ``lstm_bn``
(the batch statistics and their gradient over the global batch), packed
rows at pack factor 2 in the rank-major view and in the flat gather, and a
batch of 5 rows, which every rank computes whole and counts once (one
warning).  At keep 0.9 each rank's hash-dropout seed is the step's one
seed plus 7919·rank, and its masks (the MoE mix on its rows, the stack's)
are the reference's shard masks bit for bit.  The eval step after the two
steps gives every rank the global loss and the global rows' logits.  Then
the standard launcher
(``python -m torch.distributed.run --nproc_per_node 2``) runs
``bin.nnet_train``, which must write the 1-process checkpoint (1e-5), and
the bench, which must print the ``mesh_dp2_...`` row.

The two ranks run this file as a script (``--rank``), started once for
all the cases, side by side with the two launcher runs.
"""

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from lstm_ctc_tpu_torch import parallel  # noqa: E402
from lstm_ctc_tpu_torch.graft_entry import (  # noqa: E402
    FLAGSHIP_CONFIG, _example_batch, _packed_batch)
from lstm_ctc_tpu_torch.models import init_model  # noqa: E402
from lstm_ctc_tpu_torch.models.cells import (  # noqa: E402
    DropoutStreams, draw_seed)
from lstm_ctc_tpu_torch.train.checkpoint import (  # noqa: E402
    flatten_tree, tree_map)
from lstm_ctc_tpu_torch.train.graph import (  # noqa: E402
    compute_losses, make_eval_step, make_train_step)

WORLD = 2
TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
# one intra-op thread a process: the suite runs test files side by side
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
TINY = dict(FLAGSHIP_CONFIG, input_dim=4, num_targets=7, num_layers=2,
            num_neurons=16, num_projects=8, num_experts=4, dropout_rate=1.0,
            compute_dtype="float32", store_dtype="float32")
LSTM_BN = dict(TINY, nnet_type="lstm", num_experts=0, use_bn=True)
CASES = ("packed_flat", "indivisible", "dense", "moe", "lstm_bn",
         "packed_rank_major")
# who computes each case's JAX reference, so that the three processes
# compile JAX's train steps side by side: this process the first two
# cases (first, while the ranks run), each rank two of the others
JAX_SHARE = {0: ("dense", "moe"), 1: ("lstm_bn", "packed_rank_major")}
MASK_SEED, KEEP = 5, 0.9


def case_inputs(name):
    """(config, host batch) of a case: 4 ragged rows of T = 16 (5 for
    ``indivisible``), or 4 packed rows of 2 slots."""
    if name.startswith("packed"):
        config = dict(TINY, num_experts=0, packed_slots_rank_major=(
            name == "packed_rank_major"))
        return config, _packed_batch(config, num_rows=4, pack_factor=2)
    config = {"dense": dict(TINY, num_experts=0), "moe": TINY,
              "lstm_bn": LSTM_BN, "indivisible": TINY}[name]
    rows = 5 if name == "indivisible" else 4
    batch = _example_batch(config, batch=rows, time_steps=16, rng_seed=1)
    batch["sequence_length"] = np.array([16, 14, 15, 16, 13][:rows],
                                        np.int32)
    return config, batch


def initial_weights(config):
    return init_model(torch.Generator().manual_seed(0), config, "cpu")


def train_two_steps(name, data_parallel):
    """2 adam steps of a case: (per-step eval_loss, loss, size), the
    parameters and the state after them, as numpy."""
    config, batch = case_inputs(name)
    params, state = initial_weights(config)
    params = tree_map(lambda t: t.requires_grad_(), params)
    init_opt, step = make_train_step(config, learn_rate=1e-3,
                                     optimizer="adam")
    opt_state = init_opt(params)
    streams = DropoutStreams.for_rank("cpu", 1, parallel.rank())
    if data_parallel:
        device_batch = parallel.shard_batch(batch, "cpu")
    else:
        device_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(2):
        params, opt_state, state, m = step(params, opt_state, state, streams,
                                           device_batch)
        metrics.append((float(m["eval_loss"]), float(m["loss"]),
                        int(m["size"])))
    # the eval step after them: the global loss, the global rows' logits
    m, logits = make_eval_step(config, with_logits=True)(params, state,
                                                         device_batch)
    return {"metrics": metrics, "params": flatten_tree(params),
            "state": flatten_tree(state),
            "eval": (float(m["eval_loss"]), int(m["size"])),
            "logits": logits.numpy()}


def drawn_seeds(config, rows):
    """The hash-dropout seed the model's step draws on this rank's part of
    ``rows`` rows at keep 0.9: the MoE mix's (blstm with the MoE head) or
    the stack's (lstm)."""
    import lstm_ctc_tpu_torch.models.lstm as lstm_model
    from lstm_ctc_tpu_torch.ops import moe_kernels
    seen = {}
    mix, stack = moe_kernels.moe_mix_fused, lstm_model.lstm_stack_fused

    def spy_mix(*args, **kwargs):
        seen["seed"] = int(kwargs["seed"].reshape(()))
        return mix(*args, **kwargs)

    def spy_stack(*args, **kwargs):
        seen["seed"] = int(kwargs["seed"].reshape(()))
        return stack(*args, **kwargs)

    moe_kernels.moe_mix_fused = spy_mix
    lstm_model.lstm_stack_fused = spy_stack
    try:
        config = dict(config, dropout_rate=KEEP)
        batch = parallel.shard_batch(_example_batch(
            config, batch=rows, time_steps=16), "cpu")
        params, state = initial_weights(config)
        compute_losses(params, state, batch, config, train=True,
                       generator=DropoutStreams.for_rank(
                           "cpu", MASK_SEED, parallel.rank()))
    finally:
        moe_kernels.moe_mix_fused = mix
        lstm_model.lstm_stack_fused = stack
    return seen["seed"]


def rank_masks():
    """This rank's hash-dropout seeds and masks at keep 0.9: the MoE mix
    on its 3 of 6 rows of x (and the mix's plain version there), the
    stack's [S, L, B/2, P] mask."""
    from lstm_ctc_tpu_torch.ops import lstm_stack_kernels, moe_kernels
    r = parallel.rank()
    x, w, b, gate = mix_inputs()
    rows = slice(3 * r, 3 * r + 3)
    moe_seed = drawn_seeds(TINY, 6)
    stack_seed = drawn_seeds(dict(TINY, nnet_type="lstm", num_experts=0), 4)
    seed = torch.tensor([moe_seed], dtype=torch.int32)
    mix = moe_kernels.moe_mix_reference(
        torch.from_numpy(x[rows]), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(gate[rows]), 4, 10.0, KEEP, seed)
    keep = moe_kernels.hash_uniform(seed, 0, 0, 3, w.shape[1]) < KEEP
    stack = lstm_stack_kernels._drop_mask(
        torch.tensor([stack_seed], dtype=torch.int32), KEEP, 17, 2, 2, 8,
        "cpu") > 0
    return {"moe_seed": moe_seed, "stack_seed": stack_seed,
            "mix": mix.numpy(), "moe_mask": keep.numpy(),
            "stack_mask": stack.numpy()}


def mix_inputs():
    rng = np.random.RandomState(7)
    x = rng.randn(6, 16).astype(np.float32)
    w = (0.3 * rng.randn(16, 4 * 7)).astype(np.float32)
    b = (0.1 * rng.randn(4 * 7)).astype(np.float32)
    gate = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    return x, w, b, gate


def worker(args):
    os.environ.update(WORLD_SIZE=str(args.world), RANK=str(args.rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(args.port))
    parallel.join(torch.device("cpu"))
    out = {}
    for name in CASES:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[name] = train_two_steps(name, data_parallel=True)
        out[name]["warnings"] = [str(w.message) for w in caught
                                 if "shard_batch" in str(w.message)]
    out["masks"] = rank_masks()
    parallel.barrier()
    parallel.leave()
    # the JAX references of this rank's share, on the conftest's devices
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    out["jax"] = {name: jax_mesh_two_steps(name)
                  for name in JAX_SHARE[args.rank]}
    with open(os.path.join(args.out, "rank%d.pkl" % args.rank), "wb") as fh:
        pickle.dump(out, fh)


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start(argv, out, err=None):
    """A process of this file, its stdout into the file ``out`` and its
    stderr into ``err`` (the same file without one)."""
    with open(out, "w") as fout:
        if err is None:
            return subprocess.Popen(argv, env=ENV, cwd=REPO, text=True,
                                    stdout=fout, stderr=subprocess.STDOUT)
        with open(err, "w") as ferr:
            return subprocess.Popen(argv, env=ENV, cwd=REPO, text=True,
                                    stdout=fout, stderr=ferr)


def launcher_argv(args):
    return [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc_per_node", str(WORLD), "--master_port",
            str(free_port())] + args


class Spawned:
    """Every process of this file, started at once so that they run side
    by side: the two rank processes, and the standard launcher on
    ``nnet_train`` and on the bench.  ``results`` waits for the ranks
    (once) and returns each rank's output; ``launched`` waits for one
    launcher run and returns (exit code, stdout, stderr)."""

    def __init__(self, out):
        self.out, port = str(out), free_port()
        self.corpus = train_inputs(self.out)
        self.procs = {"rank%d" % r: start(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(WORLD), "--port", str(port), "--out", self.out],
            os.path.join(self.out, "rank%d.log" % r)) for r in range(WORLD)}
        scp, config_path, nnet0 = self.corpus
        self.two = os.path.join(self.out, "two.npz")
        for name, args in (
                ("nnet_train", ["-m", "lstm_ctc_tpu_torch.bin.nnet_train",
                                scp, config_path, nnet0, self.two]
                 + TRAIN_ARGS),
                ("bench", ["-m", "lstm_ctc_tpu_torch.bench", "--smoke",
                           "--device", "cpu", "--steps", "1"])):
            self.procs[name] = start(
                launcher_argv(args), os.path.join(self.out, name + ".out"),
                os.path.join(self.out, name + ".err"))
        self._results = None

    def wait(self, name):
        proc = self.procs[name]
        proc.wait(timeout=600)
        return proc.returncode

    def results(self):
        if self._results is None:
            for r in range(WORLD):
                code = self.wait("rank%d" % r)
                with open(os.path.join(self.out, "rank%d.log" % r)) as fh:
                    assert code == 0, fh.read()[-3000:]
            self._results = []
            for r in range(WORLD):
                with open(os.path.join(self.out, "rank%d.pkl" % r),
                          "rb") as fh:
                    self._results.append(pickle.load(fh))
        return self._results

    def launched(self, name):
        code = self.wait(name)
        with open(os.path.join(self.out, name + ".out")) as out, \
                open(os.path.join(self.out, name + ".err")) as err:
            return code, out.read(), err.read()

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = Spawned(tmp_path_factory.mktemp("ranks"))
    yield group
    group.stop()


def jax_mesh_two_steps(name):
    """The JAX package's train step on a 2-device mesh of CPU devices, from
    the same weights: per-step (eval_loss, loss, size) and the parameters
    after 2 steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from lstm_ctc_tpu.parallel import shard_batch
    from lstm_ctc_tpu.train.graph import make_train_step as jax_train_step

    config, batch = case_inputs(name)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:WORLD]), ("data",))
    replicated = NamedSharding(mesh, PartitionSpec())
    params, state = initial_weights(config)
    to_jax = (lambda tree: jax.device_put(tree_map(
        lambda t: jnp.asarray(t.detach().numpy()), tree), replicated))
    init_opt, step = jax_train_step(dict(config, mesh=mesh), learn_rate=1e-3,
                                    optimizer="adam")
    p, s = to_jax(params), to_jax(state)
    o = jax.device_put(init_opt(p), replicated)
    metrics = []
    for _ in range(2):
        p, o, s, m = step(p, o, s, jax.device_put(jax.random.PRNGKey(1),
                                                  replicated),
                          shard_batch(mesh, batch))
        metrics.append((float(m["eval_loss"]), float(m["loss"]),
                        int(m["size"])))
    return {"metrics": metrics,
            "params": flatten_tree(jax.tree.map(np.asarray, p))}


def assert_same_step(got, want, tol):
    assert [m[2] for m in got["metrics"]] == [m[2] for m in want["metrics"]]
    np.testing.assert_allclose([m[:2] for m in got["metrics"]],
                               [m[:2] for m in want["metrics"]], **tol)
    assert sorted(got["params"]) == sorted(want["params"])
    for key in want["params"]:
        np.testing.assert_allclose(got["params"][key], want["params"][key],
                                   err_msg=key, **tol)


def jax_reference(name, ranks):
    for rank, share in JAX_SHARE.items():
        if name in share:
            return ranks.results()[rank]["jax"][name]
    return jax_mesh_two_steps(name)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_process_and_jax_mesh(name, ranks):
    jax_ref = jax_reference(name, ranks)
    one = train_two_steps(name, data_parallel=False)
    assert_same_step(one, jax_ref, JAX_TOL)
    rank0, rank1 = (r[name] for r in ranks.results())
    assert_same_step(rank0, one, TOL)
    assert_same_step(rank0, jax_ref, JAX_TOL)
    # the eval step: the global batch's loss and its rows' logits
    for got in (rank0, rank1):
        assert got["eval"][1] == one["eval"][1]
        np.testing.assert_allclose(got["eval"][0], one["eval"][0], **TOL)
        np.testing.assert_allclose(got["logits"], one["logits"], **TOL)
    # every rank ends with the same weights and state
    assert rank0["metrics"] == rank1["metrics"]
    for key in rank0["params"]:
        np.testing.assert_array_equal(rank0["params"][key],
                                      rank1["params"][key], err_msg=key)
    for key in one["state"]:
        np.testing.assert_allclose(rank0["state"][key], one["state"][key],
                                   err_msg=key, **TOL)
        np.testing.assert_array_equal(rank0["state"][key],
                                      rank1["state"][key], err_msg=key)
    if name == "indivisible":
        assert len(rank0["warnings"]) == len(rank1["warnings"]) == 1
    else:
        assert rank0["warnings"] == rank1["warnings"] == []


def wrapped(value):
    return int(np.array(value, np.int64).astype(np.int32))


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_hash_masks_are_the_reference_shard_masks(rank, ranks):
    import jax.numpy as jnp
    from lstm_ctc_tpu.ops.moe_pallas import hash_uniform, moe_mix_reference
    got = ranks.results()[rank]["masks"]
    base = int(draw_seed(torch.Generator().manual_seed(MASK_SEED), "cpu"))
    seed = wrapped(base + parallel.SEED_STRIDE * rank)
    assert got["moe_seed"] == got["stack_seed"] == seed
    x, w, b, gate = mix_inputs()
    rows = slice(3 * rank, 3 * rank + 3)
    want_mask = np.asarray(hash_uniform(jnp.asarray(seed, jnp.int32), 0, 0,
                                        3, w.shape[1]) < KEEP)
    np.testing.assert_array_equal(got["moe_mask"], want_mask)
    want_mix = np.asarray(moe_mix_reference(
        jnp.asarray(x[rows]), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(gate[rows]), 4, 10.0, keep_prob=KEEP,
        seed=jnp.asarray([seed], jnp.int32)))
    np.testing.assert_allclose(got["mix"], want_mix, **TOL)
    # the stack's shard mask: rows s·L·B + l·B + b of this rank's B = 2
    want_stack = np.stack([np.asarray(hash_uniform(
        jnp.asarray(seed, jnp.int32), s * 2 * 2, 0, 2 * 2, 8) < KEEP)
        for s in range(17)])
    np.testing.assert_array_equal(got["stack_mask"].reshape(
        want_stack.shape), want_stack)


def test_split_rows_keeps_each_rank_s_slots_rank_major():
    _, batch = case_inputs("packed_rank_major")
    rows, row_t = batch["nnet_input"].shape[:2]
    parts = [parallel.split_rows(batch, r, WORLD) for r in range(WORLD)]
    assert parallel.split_rows(batch, 0, 3) is None
    for r, part in enumerate(parts):
        index = part["utt_time_index"]
        assert part["nnet_input"].shape[0] == rows // WORLD
        assert index.shape[0] == 2 * rows // WORLD
        # slot k·b + local row reads its local row, rank-major
        owner = index // row_t
        assert (owner == (np.arange(index.shape[0]) % (rows // WORLD))
                [:, None]).all()
        np.testing.assert_array_equal(
            part["nnet_input"], batch["nnet_input"][r * 2:(r + 1) * 2])
    for key in ("utt_sequence_length", "target_length"):
        assert sorted(np.concatenate([p[key] for p in parts])) == \
            sorted(batch[key])


def write_corpus(work, count=10, seed=0):
    from lstm_ctc_tpu_torch.host.data import RecordShardWriter
    rng = np.random.RandomState(seed)
    scp = os.path.join(work, "feats.scp")
    with RecordShardWriter(os.path.join(work, "feats.rec")) as writer:
        for i in range(count):
            frames = int(rng.randint(30, 71))
            labels = rng.randint(0, 6, rng.randint(2, 7)).astype(np.int32)
            writer.write("utt%02d" % i, rng.randn(frames, 4).astype(
                np.float32), labels)
        with open(scp, "w") as fh:
            fh.write("".join(m.scp_line() for m in writer.metas))
    return scp


TRAIN_ARGS = ["--objective", "ctc", "--optimizer", "adam", "--learn-rate",
              "1e-3", "--batch-size", "4", "--device", "cpu"]


def train_inputs(work):
    """(records scp, nnet.config, initial checkpoint) of ``nnet_train``:
    10 utterances, the dense-head BLSTM, the weights ``nnet_init`` makes."""
    from lstm_ctc_tpu_torch.cli import init_from_config
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.train.checkpoint import save_checkpoint
    config = dict(TINY, num_experts=0)
    config_path = os.path.join(work, "nnet.config")
    with open(config_path, "w") as fh:
        fh.write(format_config(config))
    nnet0 = os.path.join(work, "nnet.0")
    save_checkpoint(nnet0, *init_from_config(config))
    return write_corpus(work), config_path, nnet0


def test_nnet_train_under_the_launcher_writes_the_one_process_checkpoint(
        ranks):
    from lstm_ctc_tpu_torch.bin import nnet_train
    scp, config_path, nnet0 = ranks.corpus
    one = os.path.join(ranks.out, "one.npz")
    nnet_train.main([scp, config_path, nnet0, one] + TRAIN_ARGS)
    code, out, err = ranks.launched("nnet_train")
    assert code == 0, out[-2000:] + err[-3000:]
    # rank 0 alone logs
    assert err.count("INFO:tensorflow:tr_loss = ") == 1
    assert err.count('saving nnet to "%s"' % ranks.two) == 1
    got, want = np.load(ranks.two), np.load(one)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert not np.array_equal(got["params/head/w"],
                              np.load(nnet0)["params/head/w"])


def test_bench_under_the_launcher_prints_the_mesh_row(ranks):
    code, out, err = ranks.launched("bench")
    assert code == 0, out[-2000:] + err[-3000:]
    lines = [json.loads(line) for line in out.strip().splitlines()]
    names = [row["config"] for row in lines[-1]["configs"]]
    assert "mesh_dp2_b4x2_t384" in names
    mesh = lines[-1]["configs"][names.index("mesh_dp2_b4x2_t384")]
    assert mesh["frames_per_sec"] > 0 and mesh["frames_per_sec_per_chip"] > 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    worker(ap.parse_args())
