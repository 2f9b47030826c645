"""Utterance record shards — the on-disk training-data format.

The reference serializes one TFRecord *file per utterance*
(reference nnet/tfrecord.py:128-156), which is hostile to any filesystem at
LibriSpeech scale (~280k files).  Here a converter job writes many
utterances into one flat binary *shard* and indexes them with the same
5-column scp contract the reference uses
(``key num_rows num_cols has_label path``, reference
bin/convert-to-tfrecords.py:107-109 / nnet/tfrecord.py:61-85) — except
``path`` is ``shard.rec:offset`` so one shard holds thousands of
utterances.  Plain per-utterance paths are also accepted when reading.

Entry wire format (little-endian):
    magic   4 bytes  b"UTT1"
    keylen  uint32   length of the utf-8 key
    rows    int32    number of feature frames
    cols    int32    feature dimension
    tgtlen  int32    number of target labels, -1 if unlabeled
    key     keylen bytes
    feats   rows*cols float32
    labels  tgtlen int32 (absent if tgtlen < 0)

Features are stored unspliced/unsubsampled; context splicing and frame
subsampling are applied by the input pipeline at load time (as the
reference does in its tf.data map, nnet/tfrecord.py:94-119).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import logging_util as log

MAGIC = b"UTT1"
_HEADER = struct.Struct("<4sIiii")


@dataclass
class RecordMeta:
    key: str
    num_rows: int
    num_cols: int
    has_label: bool
    path: str        # shard path (no offset suffix)
    offset: int      # byte offset of the entry inside the shard

    def scp_line(self) -> str:
        return "%s %d %d %d %s:%d\n" % (
            self.key, self.num_rows, self.num_cols,
            1 if self.has_label else 0, self.path, self.offset)


class RecordShardWriter:
    """Appends utterance entries to one shard file and tracks scp metadata."""

    def __init__(self, shard_path: str):
        self.shard_path = shard_path
        self._fh = open(shard_path, "wb")
        self.metas: List[RecordMeta] = []

    def write(self, key: str, feats: np.ndarray,
              labels: Optional[np.ndarray] = None) -> RecordMeta:
        feats = np.ascontiguousarray(feats, dtype="<f4")
        if feats.ndim != 2:
            raise ValueError("features for %r must be [frames, dim]" % key)
        key_bytes = key.encode("utf-8")
        tgtlen = -1 if labels is None else int(len(labels))
        offset = self._fh.tell()
        self._fh.write(_HEADER.pack(MAGIC, len(key_bytes),
                                    feats.shape[0], feats.shape[1], tgtlen))
        self._fh.write(key_bytes)
        self._fh.write(feats.tobytes())
        if labels is not None:
            self._fh.write(np.ascontiguousarray(labels, dtype="<i4").tobytes())
        meta = RecordMeta(key, feats.shape[0], feats.shape[1],
                          labels is not None, self.shard_path, offset)
        self.metas.append(meta)
        return meta

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_record(path: str, offset: int = 0,
                fh=None) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
    """Read one entry; pass a kept-open file handle for bulk reads."""
    own = fh is None
    if own:
        fh = open(path, "rb")
    try:
        fh.seek(offset)
        header = fh.read(_HEADER.size)
        magic, keylen, rows, cols, tgtlen = _HEADER.unpack(header)
        if magic != MAGIC:
            raise IOError("bad record magic at %s:%d" % (path, offset))
        key = fh.read(keylen).decode("utf-8")
        feats = np.frombuffer(fh.read(4 * rows * cols),
                              dtype="<f4").reshape(rows, cols)
        labels = None
        if tgtlen >= 0:
            labels = np.frombuffer(fh.read(4 * tgtlen), dtype="<i4")
        return key, feats, labels
    finally:
        if own:
            fh.close()


def _split_offset(path: str) -> Tuple[str, int]:
    if ":" in path and path.rsplit(":", 1)[1].isdigit():
        base, off = path.rsplit(":", 1)
        return base, int(off)
    return path, 0


def scan_scp(scp_path: str) -> List[RecordMeta]:
    """Parse a 5-column records scp, enforcing the reference's consistency
    checks (uniform dim and has_label, reference nnet/tfrecord.py:76-92)."""
    metas: List[RecordMeta] = []
    input_dim: Optional[int] = None
    has_label: Optional[bool] = None
    with open(scp_path) as fh:
        for line in fh:
            tokens = line.split()
            if not tokens:
                continue
            if len(tokens) != 5:
                log.die("bad records scp line in %s: %r" % (scp_path, line))
            key, rows, cols, lab = tokens[0], int(tokens[1]), int(tokens[2]), \
                bool(int(tokens[3]))
            path, offset = _split_offset(tokens[4])
            if input_dim is None:
                input_dim = cols
            if has_label is None:
                has_label = lab
            if cols != input_dim:
                log.die("inconsistent nnet_input dimension in records:"
                        " %d vs. %d" % (input_dim, cols))
            if lab != has_label:
                log.die("inconsistent has_label in records: %d vs. %d"
                        % (has_label, lab))
            metas.append(RecordMeta(key, rows, cols, lab, path, offset))
    return metas


def scan_label_lengths(metas: List[RecordMeta]) -> List[int]:
    """Read just the entry headers to collect per-utterance label lengths
    (needed up front for label-axis bucketing)."""
    lengths: List[int] = []
    handles: Dict[str, object] = {}
    try:
        for meta in metas:
            fh = handles.get(meta.path)
            if fh is None:
                fh = open(meta.path, "rb")
                handles[meta.path] = fh
            fh.seek(meta.offset)
            magic, _, _, _, tgtlen = _HEADER.unpack(fh.read(_HEADER.size))
            if magic != MAGIC:
                raise IOError("bad record magic at %s:%d"
                              % (meta.path, meta.offset))
            lengths.append(max(tgtlen, 0))
    finally:
        for fh in handles.values():
            fh.close()
    return lengths


class RecordLoader:
    """Loads entries keeping per-shard file handles open."""

    def __init__(self):
        self._handles: Dict[str, object] = {}

    def load(self, meta: RecordMeta):
        fh = self._handles.get(meta.path)
        if fh is None:
            fh = open(meta.path, "rb")
            self._handles[meta.path] = fh
        return read_record(meta.path, meta.offset, fh=fh)

    def close(self) -> None:
        for fh in self._handles.values():
            fh.close()
        self._handles.clear()
