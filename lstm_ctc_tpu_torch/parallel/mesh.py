"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``lstm_ctc_tpu/parallel/mesh.py``.  The reference lays a
1-D ``data`` mesh over every local device, splits each batch on its
leading axis and replicates the parameters; XLA inserts the gradient
all-reduce.  Here the mesh is a process group, one process (rank) per
card, each holding a whole replica of the parameters:

* ``join`` enters the group the standard launcher describes in the
  environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``, as ``python -m torch.distributed.run`` sets them):
  NCCL on cards, gloo on the CPU;
* ``shard_batch`` gives rank r the rows [r·B/N, (r+1)·B/N) of a batch,
  and of a packed batch the utterance slots those rows own, their time
  indices rebased to the local rows (the rank-major slot order is kept);
  a batch whose rows do not divide the group is computed whole on every
  rank and counted once, with a one-time warning, as the reference
  replicates it;
* ``combine`` makes each rank's gradients and metrics the global ones:
  the sum over the ranks of a split batch (the loss is a sum over
  sequences, not a mean), rank 0's of a whole one.

The train step (``train/graph.py``) adds the L2 term's gradient once
after ``combine``, then clips by the global norm and applies the
optimizer, so the parameters stay equal on every rank.  Batch-norm
statistics of a split batch are taken over the global batch with a
differentiable all-reduce (``models/lstm.py``), and the hash-dropout seed
of rank r is the step's one seed plus 7919·r (``SEED_STRIDE``), as the
reference's shard r offsets it.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the hash-dropout seed offset of one rank (the reference's shard offset,
# ops/moe_pallas.py:680-682, ops/lstm_stack_pallas.py:782-784)
SEED_STRIDE = 7919
# the device batch's entry that says how it lies over the group
SHARD_KEY = "shard"

_warned_whole = False


@dataclass(frozen=True)
class Shard:
    """How one device batch lies over the group: its rows ``split`` over
    the ``world`` ranks (this one is ``rank``), or whole on every rank."""
    rank: int
    world: int
    split: bool


def launched() -> bool:
    """Whether the launcher's environment names a process group."""
    return "WORLD_SIZE" in os.environ


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def local_device(device: torch.device) -> torch.device:
    """The card of this rank (``LOCAL_RANK``) for a ``cuda`` device named
    without an index, when the launcher's environment is set."""
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def join(device: torch.device, backend: Optional[str] = None) -> bool:
    """Enter the process group the launcher's environment describes, if
    it names one and none is active (NCCL for a card, gloo for the CPU,
    unless ``backend`` says otherwise); returns whether it entered one."""
    if active() or not launched():
        return False
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def leave() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def split_rows(arrays: Dict[str, np.ndarray], rank: int,
               world: int) -> Optional[Dict[str, np.ndarray]]:
    """Rank ``rank``'s part of a host batch: rows [r·B/N, (r+1)·B/N), and
    of a packed batch the slots whose row is one of them, in their order,
    with their time indices rebased to the local rows; None when the rows
    do not divide ``world``."""
    num_rows, row_t = arrays["nnet_input"].shape[:2]
    if num_rows % world:
        return None
    per = num_rows // world
    lo, hi = rank * per, (rank + 1) * per
    out = {k: arrays[k][lo:hi] for k in ("nnet_input", "sequence_length",
                                         "reset_mask") if k in arrays}
    if "utt_time_index" in arrays:
        # a slot's row: every entry of its time index lies in that row (the
        # batcher asserts it for dummy slots too)
        rows = arrays["utt_time_index"][:, 0] // row_t
        mine = np.nonzero((rows >= lo) & (rows < hi))[0]
        out["utt_time_index"] = (arrays["utt_time_index"][mine]
                                 - lo * row_t).astype(np.int32)
        for key in ("utt_sequence_length", "nnet_target", "target_length"):
            out[key] = arrays[key][mine]
    else:
        for key in ("nnet_target", "target_length"):
            out[key] = arrays[key][lo:hi]
    return out


def shard_batch(arrays: Dict[str, np.ndarray], device) -> Dict:
    """A host batch → dict of tensors on ``device``: this rank's part when
    a process group is active (with its ``Shard`` under ``SHARD_KEY``),
    else the whole batch."""
    global _warned_whole
    shard = None
    if active():
        r, n = rank(), world_size()
        part = split_rows(arrays, r, n)
        if part is None:
            if not _warned_whole:
                _warned_whole = True
                warnings.warn(
                    "shard_batch: %d rows do not divide the %d ranks; every "
                    "rank computes the whole batch, counted once (an up-to-"
                    "%dx throughput loss). Pad or resize batches to a "
                    "multiple of the group's size."
                    % (arrays["nnet_input"].shape[0], n, n), stacklevel=2)
        else:
            arrays = part
        shard = Shard(r, n, part is not None)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in arrays.items()}
    if shard is not None:
        out[SHARD_KEY] = shard
    return out


def combine(shard: Shard, grads: List[torch.Tensor],
            metrics: Dict) -> Tuple[List[torch.Tensor], Dict]:
    """This rank's gradients and metrics → the global ones: their sum
    over the ranks for a split batch, rank 0's for a whole one.  Both
    travel in one flat float32 buffer, the metrics (``size``,
    ``eval_loss``, ``loss``) at its end (a label count is exact there up
    to 2^24)."""
    keys = sorted(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].detach().float()
                                     for k in keys])])
    if shard.split:
        dist.all_reduce(flat)
    else:
        dist.broadcast(flat, 0)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out, {k: flat[at + i].to(metrics[k].dtype)
                 for i, k in enumerate(keys)}


def gather_rows(shard: Shard, local: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a per-row tensor (e.g. logits) from each
    rank's equal part, in rank order; a whole batch is returned as it is.
    An all-reduce of a zero-padded buffer, which every backend runs on
    card tensors."""
    if not shard.split or shard.world == 1:
        return local
    rows = local.shape[0]
    full = local.new_zeros((shard.world * rows,) + local.shape[1:])
    full[shard.rank * rows:(shard.rank + 1) * rows] = local
    dist.all_reduce(full)
    return full


def batch_moments(x_flat: torch.Tensor, shard: Optional[Shard]):
    """(mean, variance) over the rows of ``x_flat`` ``[N, C]``, taken over
    the global batch for a split one: Σx, Σx² and the count reduced over
    the ranks with a differentiable all-reduce, so the gradient flows
    through the global statistics; else the local ``mean`` and ``var``."""
    if shard is None or not shard.split:
        return x_flat.mean(0), x_flat.var(0, unbiased=False)
    from torch.distributed.nn.functional import all_reduce
    count = x_flat.new_full((1,), float(x_flat.shape[0]))
    sums = all_reduce(torch.cat([x_flat.sum(0), (x_flat * x_flat).sum(0),
                                 count]))
    channels = x_flat.shape[1]
    mean = sums[:channels] / sums[-1]
    var = sums[channels:2 * channels] / sums[-1] - mean * mean
    return mean, var
