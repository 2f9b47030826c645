"""Shared plumbing for the port's command-line tools (counterpart of
``lstm_ctc_tpu/cli.py:45-111``)."""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from .host.data import BucketedBatcher, scan_scp
from .models import init_model


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def resolve_device(arg: str) -> torch.device:
    """``cuda``, ``cuda:N`` or ``cpu``.  Asking for CUDA where there is no
    GPU raises: the run never carries on on the CPU."""
    device = torch.device(arg)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device %s: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)" % arg)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % arg)
    return device


def build_batcher(records_scp: str, config: Dict,
                  batch_size: int) -> BucketedBatcher:
    """Length-bucketed unlabeled batches with the config's splice and
    subsampling (inference needs no label lengths)."""
    return BucketedBatcher(
        scan_scp(records_scp),
        batch_size=batch_size,
        left_context=config.get("left_context", 0) or 0,
        right_context=config.get("right_context", 0) or 0,
        subsample=config.get("subsample", 0) or 0,
    )


def init_from_config(config: Dict, device="cpu"):
    """Deterministic model init seeded from the config's ``seed`` key."""
    seed = int(config.get("seed", 777) or 777)
    generator = torch.Generator().manual_seed(seed)
    return init_model(generator, config, device)
