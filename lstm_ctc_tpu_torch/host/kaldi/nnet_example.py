"""Kaldi nnet3 training-example (``<Nnet3Eg>``) reader.

Capability mirror of reference pyKaldiIO/nnet_example.py:60-94 and
nnet_common.py:41-93: parses NnetIo entries (name + compressed Index
vector + Float/Compressed/Sparse matrix features) so existing Kaldi nnet3
egs archives can be imported as training data.

The Index vector's binary compression stores per-element either a SIGNED
one-byte time delta or the escape 127 followed by explicit (n, t, x) —
the reference decoded the byte unsigned (nnet_common.py:60: ``abs(ord(c))``
never sees negatives), which breaks on negative deltas; this
implementation decodes it signed, matching Kaldi.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .binio import (
    KaldiIOError,
    expect_token,
    read_basic,
    read_int32,
    read_matrix,
    read_token,
)


@dataclass
class Index:
    n: int = 0
    t: int = 0
    x: int = 0


def read_index_vector(stream, binary: bool) -> List[Index]:
    expect_token(stream, binary, "<I1V>")
    size = read_int32(stream, binary)
    if size < 0:
        raise KaldiIOError("bad Index vector size %d" % size)
    vec: List[Index] = []
    if not binary:
        for _ in range(size):
            expect_token(stream, binary, "<I1>")
            vec.append(Index(read_int32(stream, binary),
                             read_int32(stream, binary),
                             read_int32(stream, binary)))
        return vec
    for i in range(size):
        raw = stream.read(1)
        if not raw:
            raise KaldiIOError("EOF in Index vector")
        delta = int.from_bytes(raw, "little", signed=True)
        if abs(delta) < 125:
            prev = vec[i - 1] if i > 0 else Index()
            vec.append(Index(prev.n, prev.t + delta, prev.x))
        elif delta == 127:
            vec.append(Index(read_int32(stream, binary),
                             read_int32(stream, binary),
                             read_int32(stream, binary)))
        else:
            raise KaldiIOError("unexpected Index escape byte %d" % delta)
    return vec


def _read_sparse_matrix(stream, binary: bool):
    """SparseMatrix of SparseVectors (pyKaldiIO kaldi_matrix.py:253-339):
    returned as a list of [(index, value), ...] rows."""
    expect_token(stream, binary, "SM")
    num_rows = read_int32(stream, binary)
    if num_rows < 0 or num_rows > 10000000:
        raise KaldiIOError("implausible sparse-matrix rows %d" % num_rows)
    rows = []
    for _ in range(num_rows):
        expect_token(stream, binary, "SV")
        dim = read_int32(stream, binary)
        if dim < 0:
            raise KaldiIOError("negative sparse-vector dim")
        num_elems = read_int32(stream, binary)
        if num_elems < 0 or num_elems > dim:
            raise KaldiIOError("bad sparse-vector element count")
        pairs = []
        for _ in range(num_elems):
            idx = read_int32(stream, binary)
            val = read_basic(stream, binary, "float32")
            pairs.append((idx, val))
        rows.append(pairs)
    return rows


@dataclass
class NnetIo:
    name: str = ""
    indexes: List[Index] = field(default_factory=list)
    features = None  # np.ndarray (dense) or list of sparse rows


@dataclass
class NnetExample:
    io: List[NnetIo] = field(default_factory=list)

    def get_feature(self, name: str = "input") -> Optional[np.ndarray]:
        for entry in self.io:
            if entry.name == name and isinstance(entry.features, np.ndarray):
                return entry.features
        return None

    def get_label(self, name: str = "output") -> Optional[List[int]]:
        for entry in self.io:
            if entry.name == name and isinstance(entry.features, list):
                return [pair[0] for row in entry.features for pair in row]
        return None


def read_nnet_example(stream, binary: bool) -> NnetExample:
    expect_token(stream, binary, "<Nnet3Eg>")
    expect_token(stream, binary, "<NumIo>")
    size = read_int32(stream, binary)
    if size <= 0 or size > 1000000:
        raise KaldiIOError("bad <NumIo> %d" % size)
    example = NnetExample()
    for _ in range(size):
        entry = NnetIo()
        expect_token(stream, binary, "<NnetIo>")
        entry.name = read_token(stream, binary)
        entry.indexes = read_index_vector(stream, binary)
        peeked = stream.peek(1)
        if peeked == b"S":
            entry.features = _read_sparse_matrix(stream, binary)
        else:
            entry.features = read_matrix(stream, binary)
        expect_token(stream, binary, "</NnetIo>")
        example.io.append(entry)
    expect_token(stream, binary, "</Nnet3Eg>")
    return example
