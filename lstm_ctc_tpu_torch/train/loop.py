"""Epoch loops with the reference's machine-readable logging contract.

Counterpart of ``lstm_ctc_tpu/train/loop.py`` (the reference's
nnet/funcs.py:23-152): a size-weighted running mean of the per-label loss,
periodic ``step = N, batch_size = B, loss = L`` lines, a fatal exit on a NaN
running loss, and the summary lines ``tr_loss = X`` / ``cv_loss = X`` /
``cv_eval = X`` that the outer-loop shell scripts scrape.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np

from ..host import logging_util as log
from ..host.decode import (dense_targets_to_lists, edit_distance_batch,
                           greedy_decode)


class MetricsWriter:
    """Per-run JSONL scalar log; opened with truncation, so a re-run of an
    epoch starts a clean file."""

    def __init__(self, path: Optional[str]):
        self._fh = open(path, "w") if path else None
        self._t0 = time.perf_counter()

    def write(self, **scalars) -> None:
        if self._fh is None:
            return
        scalars["wall_time"] = round(time.perf_counter() - self._t0, 4)
        self._fh.write(json.dumps(scalars) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class EpochStats:
    """Size-weighted running means (funcs.py:44-54 arithmetic)."""

    def __init__(self):
        self.processed = 0
        self.loss = 0.0
        self.eval = 0.0
        self.steps = 0

    def update(self, size: int, eval_loss: float,
               eval_dist: Optional[float] = None):
        self.steps += 1
        if size > 0:
            self.processed += size
            batch_loss = eval_loss / size
            self.loss += (batch_loss - self.loss) * size / self.processed
            if eval_dist is not None:
                batch_eval = eval_dist / size
                self.eval += (batch_eval - self.eval) * size / self.processed


def run_training_epoch(train_step: Callable,
                       params, opt_state, net_state,
                       batches: Iterable,
                       shard_fn: Callable,
                       generator,
                       report_interval: Optional[int] = 100,
                       metrics_writer: Optional[MetricsWriter] = None):
    """One training epoch.  Returns (params, opt_state, net_state, stats).
    Exits(1) on a NaN running loss, logging ``tr_loss`` first (funcs.py:
    64-81).  ``generator`` draws the dropout masks."""
    stats = EpochStats()
    step_t0 = time.perf_counter()
    for batch in batches:
        device_batch = shard_fn(batch)
        params, opt_state, net_state, metrics = train_step(
            params, opt_state, net_state, generator, device_batch)
        size = int(metrics["size"])
        eval_loss = float(metrics["eval_loss"])
        stats.update(size, eval_loss)
        if metrics_writer is not None:
            now = time.perf_counter()
            frames = int(np.sum(np.asarray(batch.sequence_length)))
            metrics_writer.write(
                step=stats.steps, loss=stats.loss, size=size,
                batch_loss=eval_loss / max(size, 1),
                step_time=round(now - step_t0, 4),
                frames_per_sec=round(frames / max(now - step_t0, 1e-9), 1))
            step_t0 = now
        if report_interval and stats.steps % report_interval == 0:
            log.info("step = %d, batch_size = %d, loss = %f"
                     % (stats.steps, size, stats.loss))
        if math.isnan(stats.loss):
            log.info("tr_loss = %f" % stats.loss)
            log.fatal("nan loss detected")
            sys.exit(1)
    log.info("done")
    log.info("tr_loss = %f" % stats.loss)
    return params, opt_state, net_state, stats


def run_validation_epoch(eval_step: Callable,
                         params, net_state,
                         batches: Iterable,
                         shard_fn: Callable,
                         evaluate: bool = False,
                         report_interval: Optional[int] = 100):
    """One CV epoch.  Logs ``cv_loss`` (and ``cv_eval`` when evaluate) and
    returns stats.  eval_step returns (metrics, logits) when evaluate is
    set, else metrics only."""
    stats = EpochStats()
    for batch in batches:
        device_batch = shard_fn(batch)
        if evaluate:
            metrics, logits = eval_step(params, net_state, device_batch)
            hyps = greedy_decode(logits.float().cpu().numpy(),
                                 np.asarray(batch.sequence_length))
            refs = dense_targets_to_lists(batch.nnet_target)
            if len(hyps) != len(refs):
                # packed batches have B row-level hypotheses but
                # B·pack_factor per-utterance references
                raise ValueError(
                    "evaluate=True needs unpacked batches (got %d "
                    "hypotheses vs %d references; run CV with "
                    "pack_factor=1)" % (len(hyps), len(refs)))
            dist = float(edit_distance_batch(hyps, refs))
        else:
            metrics = eval_step(params, net_state, device_batch)
            dist = None
        size = int(metrics["size"])
        stats.update(size, float(metrics["eval_loss"]), dist)
        if report_interval and stats.steps % report_interval == 0:
            line = "step = %d, batch_size = %d, loss = %f" \
                % (stats.steps, size, stats.loss)
            if evaluate:
                line += ", eval = %f" % stats.eval
            log.info(line)
        if math.isnan(stats.loss):
            log.info("cv_loss = %f" % stats.loss)
            log.fatal("nan loss detected")
            sys.exit(1)
    log.info("done")
    log.info("cv_loss = %f" % stats.loss)
    if evaluate:
        log.info("cv_eval = %f" % stats.eval)
    return stats
