"""The flagship model's examples and forward entry point.

The port's counterpart of ``__graft_entry__.py``: ``FLAGSHIP_CONFIG`` (the
WSJ treatment model), ``_example_batch`` (full-length random rows and short
random labels), ``_packed_batch`` (a real packed batch from the port's
``BucketedBatcher``) and ``entry()``, the flagship forward at full width
with its example arguments.  The bench, ``scripts/profile_step`` and the
A/B tool build on them.  The reference's ``dryrun_multichip`` has no copy
here: its passes are the data-parallel tests (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import numpy as np

FLAGSHIP_CONFIG = {
    # egs/wsj/run_wsj_phn.sh:10-46 treatment model
    "nnet_type": "blstm",
    "input_dim": 40,
    "left_context": 1,
    "right_context": 1,
    "subsample": 3,
    "num_layers": 4,
    "num_neurons": 320,
    "num_projects": 320,
    "num_targets": 72,
    "use_peepholes": True,
    "dropout_rate": 0.9,
    "num_experts": 72,
    "moe_temp": 10.0,
    "seed": 777,
    # packed batches here always come from BucketedBatcher
    # (_packed_batch), whose slot layout is rank-major
    "packed_slots_rank_major": True,
}


def _example_batch(config, batch=4, time_steps=64, rng_seed=0):
    """Full-length random rows ``[batch, time_steps, D·ctx]`` and 2-7
    random labels a row, from a numpy seed."""
    rng = np.random.RandomState(rng_seed)
    dim = config["input_dim"] * (
        1 + config["left_context"] + config["right_context"])
    num_classes = config["num_targets"]
    max_u = 8
    feats = rng.randn(batch, time_steps, dim).astype(np.float32)
    seq_len = np.full((batch,), time_steps, np.int32)
    labels = np.full((batch, max_u), -1, np.int32)
    tgt_len = np.zeros((batch,), np.int32)
    for b in range(batch):
        u = rng.randint(2, max_u)
        labels[b, :u] = rng.randint(0, num_classes - 1, u)
        tgt_len[b] = u
    return {
        "nnet_input": feats,
        "sequence_length": seq_len,
        "nnet_target": labels,
        "target_length": tgt_len,
    }


def _packed_batch(config, num_rows=16, pack_factor=2, rng_seed=0):
    """A real packed batch (multi-utterance rows) from the batcher: exactly
    ``num_rows`` rows with ``pack_factor`` utterance slots per row."""
    from .host.data import BucketedBatcher, RecordMeta

    rng = np.random.RandomState(rng_seed)
    raw_dim = config["input_dim"]
    n_utts = 8 * num_rows * pack_factor
    lengths = rng.randint(24, 60, size=n_utts)
    metas = [RecordMeta("u%04d" % i, int(t), raw_dim, True, "mem", i)
             for i, t in enumerate(lengths)]
    feats = {m.key: rng.randn(m.num_rows, raw_dim).astype(np.float32)
             for m in metas}
    labs = {m.key: rng.randint(
        0, config["num_targets"] - 1,
        max(2, int(m.num_rows) // 12)).astype(np.int32) for m in metas}

    class Loader:
        def load(self, meta):
            return meta.key, feats[meta.key], labs[meta.key]

        def close(self):
            pass

    batcher = BucketedBatcher(
        metas, batch_size=num_rows,
        left_context=config["left_context"],
        right_context=config["right_context"],
        subsample=config["subsample"],
        label_lengths=[len(labs[m.key]) for m in metas],
        pack_factor=pack_factor)
    plan = batcher.batch_plan(shuffle=True, seed=0)
    bucket_idx, rows = plan[0]
    b = batcher.assemble(bucket_idx, rows, Loader())
    out = {
        "nnet_input": b.nnet_input,
        "sequence_length": b.sequence_length,
        "nnet_target": b.nnet_target,
        "target_length": b.target_length,
        "reset_mask": b.reset_mask,
        "utt_time_index": b.utt_time_index,
        "utt_sequence_length": b.utt_sequence_length,
    }
    assert out["nnet_input"].shape[0] == num_rows, out["nnet_input"].shape
    assert out["utt_time_index"].shape[0] == num_rows * pack_factor
    return out


def entry(device="cuda"):
    """→ (forward, (params, nnet_input, sequence_length)): the flagship
    forward at full width (``train=False``) on random weights from a seed,
    and ``_example_batch``'s input (B = 4, T = 64) on ``device``."""
    import torch

    from .cli import resolve_device
    from .models import apply_model, init_model

    device = resolve_device(device)
    config = dict(FLAGSHIP_CONFIG)
    params, net_state = init_model(torch.Generator().manual_seed(0), config,
                                   device)
    batch = _example_batch(config)

    def forward(params, nnet_input, sequence_length):
        with torch.no_grad():
            logits, _, _, _ = apply_model(
                params, net_state, nnet_input, sequence_length, config,
                train=False)
        return logits

    return forward, (params,
                     torch.from_numpy(batch["nnet_input"]).to(device),
                     torch.from_numpy(batch["sequence_length"]).to(device))
