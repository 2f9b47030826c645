"""Kaldi-nnet1-style frame-level randomizers.

Capability mirror of reference pyKaldiIO/nnet_randomizer.py:22-211: large
frame-shuffling buffers for framewise (cross-entropy-style) training.
The CTC pipeline itself batches whole utterances (data/pipeline.py); these
exist for framewise objectives and for parity with the reference's export
surface (pyKaldiIO/__init__.py:29-33).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class NnetDataRandomizerOptions:
    randomizer_size: int = 32768   # frames held in the buffer
    randomizer_seed: int = 777
    minibatch_size: int = 256


class RandomizerMask:
    """Generates the shared shuffle permutation (reference
    nnet_randomizer.py:22-44)."""

    def __init__(self, options: Optional[NnetDataRandomizerOptions] = None):
        self.options = options or NnetDataRandomizerOptions()
        self._rng = np.random.RandomState(self.options.randomizer_seed)

    def generate(self, size: int) -> np.ndarray:
        return self._rng.permutation(size).astype(np.int64)

    Generate = generate


class _BufferedRandomizer:
    """Accumulate rows, shuffle with a provided mask, drain minibatches."""

    def __init__(self, options: Optional[NnetDataRandomizerOptions] = None):
        self.options = options or NnetDataRandomizerOptions()
        self._buffer = None
        self._read_pos = 0

    def add_data(self, rows: np.ndarray) -> None:
        rows = np.atleast_1d(rows)
        if self._buffer is None:
            self._buffer = rows.copy()
        else:
            if self._read_pos > 0:
                self._buffer = self._buffer[self._read_pos:]
                self._read_pos = 0
            self._buffer = np.concatenate([self._buffer, rows], axis=0)

    AddData = add_data

    def randomize(self, mask: np.ndarray) -> None:
        live = self._buffer[self._read_pos:]
        if len(mask) != len(live):
            raise ValueError("mask size %d != buffered rows %d"
                             % (len(mask), len(live)))
        self._buffer = live[mask]
        self._read_pos = 0

    Randomize = randomize

    def is_full(self) -> bool:
        return self._buffer is not None and \
            (len(self._buffer) - self._read_pos) >= \
            self.options.randomizer_size

    IsFull = is_full

    def done(self) -> bool:
        return self._buffer is None or \
            (len(self._buffer) - self._read_pos) < \
            self.options.minibatch_size

    Done = done

    def value(self) -> np.ndarray:
        n = self.options.minibatch_size
        out = self._buffer[self._read_pos:self._read_pos + n]
        return out

    Value = value

    def next(self) -> None:
        self._read_pos += self.options.minibatch_size

    Next = next

    def num_frames(self) -> int:
        return 0 if self._buffer is None \
            else len(self._buffer) - self._read_pos

    NumFrames = num_frames


class MatrixRandomizer(_BufferedRandomizer):
    pass


class Int32VectorRandomizer(_BufferedRandomizer):
    pass


class FloatVectorRandomizer(_BufferedRandomizer):
    pass
