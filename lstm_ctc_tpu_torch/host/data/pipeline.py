"""Host input pipeline: splice/subsample + length-bucketed padded batches.

The port's copy of ``lstm_ctc_tpu/data/pipeline.py``; it loads records with
the numpy ``RecordLoader`` only (the reference's optional native loader
reads the same bytes into the same arrays).

The reference pads every batch to the longest utterance in it with tf.data's
``padded_batch`` (reference nnet/pipeline.py:35-51), which on TPU would
trigger one XLA recompilation per distinct batch shape.  Here utterances are
assigned to a small, dataset-stable set of *length buckets*; every batch from
a bucket has the same ``[B, T_bucket, D]`` / ``[B, U_bucket]`` shape, so the
jitted train step compiles once per bucket and never again.

Padding semantics match the reference: features pad with 0.0, targets with
-1 (reference nnet/pipeline.py:43-47).  Short final batches are filled with
dummy rows of ``sequence_length == 0`` whose targets are all -1, so they
contribute nothing to the label-count normalizer ``size``
(reference nnet/graph.py:105-106) nor to the CTC loss.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .records import RecordLoader, RecordMeta


# ---------------------------------------------------------------------------
# Per-utterance transforms (reference nnet/tfrecord.py:28-51 semantics)
# ---------------------------------------------------------------------------

def splice_frames(feats: np.ndarray, left_context: int,
                  right_context: int) -> np.ndarray:
    """Stack ±context frames per frame, edge-padding with the first/last
    frame.  [T, D] → [T, D*(1+left+right)]."""
    if not left_context and not right_context:
        return feats
    num_rows = feats.shape[0]
    padded = np.concatenate(
        [np.repeat(feats[:1], left_context, axis=0), feats,
         np.repeat(feats[-1:], right_context, axis=0)], axis=0)
    window = left_context + right_context + 1
    cols = [padded[i:i + num_rows] for i in range(window)]
    return np.concatenate(cols, axis=1)


def subsample_frames(feats: np.ndarray, factor: int) -> np.ndarray:
    """Keep every ``factor``-th frame; output length is floor(T/factor),
    matching the reference's ``range(T/factor)*factor`` gather
    (nnet/tfrecord.py:43-51)."""
    if not factor or factor == 1:
        return feats
    out_len = feats.shape[0] // factor
    return feats[:out_len * factor:factor]


def output_length(num_rows: int, subsample: int) -> int:
    if not subsample or subsample == 1:
        return num_rows
    return num_rows // subsample


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

DEFAULT_TIME_QUANT = 64
DEFAULT_LABEL_QUANT = 16


def _quantize(value: int, quant: int, minimum: int) -> int:
    return max(minimum, -(-value // quant) * quant)


@dataclass
class Bucket:
    time_steps: int              # padded T for every batch in this bucket
    label_steps: int             # padded U
    member_indices: List[int] = field(default_factory=list)


@dataclass
class Batch:
    """One padded batch of host arrays, contract-named like the reference
    pipeline dict (reference nnet/pipeline.py:59-64).

    With multi-utterance row packing (``pack_factor > 1``) each row holds
    several utterances back-to-back and the optional fields below carry
    the packing structure: ``reset_mask`` [B, T] marks segment starts
    (the model zeroes its recurrent carry there), and the per-utterance
    view (``utt_time_index`` [N, T_u] flat indices into the row-major
    [B·T] frames, ``utt_sequence_length`` [N]) lets the CTC loss see each
    packed utterance exactly as if it had its own row; ``nnet_target`` /
    ``target_length`` are then per-utterance [N, U] / [N], and ``keys``
    is slot-indexed alongside them ("" for dummy slots).

    Slot-layout CONTRACT (consumers rely on it — train/graph.py builds
    the CTC view as a per-row gather so a batch-sharded mesh never
    all-gathers the logits): slots are RANK-MAJOR, row r's k-th-longest
    utterance at slot ``k·B + r``, so ``slot % B`` is the owning row and
    every ``utt_time_index[slot]`` entry stays inside that row's
    [row·T, row·T + T) index range (dummy slots included)."""
    nnet_input: np.ndarray       # [B, T, D] float32
    sequence_length: np.ndarray  # [B] int32 (0 for padding rows)
    nnet_target: np.ndarray      # [B or N, U] int32, padded with -1
    target_length: np.ndarray    # [B or N] int32
    keys: List[str] = field(default_factory=list)
    reset_mask: Optional[np.ndarray] = None          # [B, T] float32
    utt_time_index: Optional[np.ndarray] = None      # [N, T_u] int32
    utt_sequence_length: Optional[np.ndarray] = None  # [N] int32

    @property
    def size(self) -> int:
        """Total number of real target labels — the loss normalizer
        (reference nnet/graph.py:105-106)."""
        return int((self.nnet_target >= 0).sum())


class BucketedBatcher:
    """Assigns utterances to static length buckets and yields fixed-shape
    padded batches in shuffled order."""

    def __init__(self,
                 metas: Sequence[RecordMeta],
                 batch_size: int,
                 left_context: int = 0,
                 right_context: int = 0,
                 subsample: int = 0,
                 time_quant: int = DEFAULT_TIME_QUANT,
                 label_quant: int = DEFAULT_LABEL_QUANT,
                 label_lengths: Optional[Sequence[int]] = None,
                 pack_factor: int = 1):
        self.metas = list(metas)
        self.batch_size = batch_size
        self.left_context = left_context
        self.right_context = right_context
        self.subsample = subsample
        self.pack_factor = max(1, int(pack_factor or 1))
        if not self.metas:
            raise ValueError("empty dataset")
        self.input_dim = self.metas[0].num_cols * (
            1 + left_context + right_context)

        # Bucket shapes are a pure function of the dataset → stable across
        # epochs → a fixed set of XLA compilations.
        lengths = [output_length(m.num_rows, subsample) for m in self.metas]
        buckets: Dict[int, Bucket] = {}
        for idx, t_len in enumerate(lengths):
            t_pad = _quantize(t_len, time_quant, time_quant)
            bucket = buckets.setdefault(t_pad, Bucket(t_pad, 0))
            bucket.member_indices.append(idx)
        if label_lengths is None:
            label_lengths = [0] * len(self.metas)
        for bucket in buckets.values():
            max_u = max((label_lengths[i] for i in bucket.member_indices),
                        default=0)
            bucket.label_steps = _quantize(max_u, label_quant, label_quant)
        self.buckets = [buckets[k] for k in sorted(buckets)]
        self._lengths = lengths
        self._label_lengths = list(label_lengths)

        # Multi-utterance row packing: ONE row shape for the whole
        # dataset — rows of row_time frames greedily filled with whole
        # utterances back-to-back (padding only at the row tail), at most
        # pack_factor utterances per row.  Removes per-bucket padding
        # waste and shrinks the compiled-shape set to one.
        if self.pack_factor > 1:
            self.row_time = _quantize(max(lengths), time_quant, time_quant)
            self.row_label = _quantize(
                max(label_lengths) if label_lengths else 0,
                label_quant, label_quant)

    def shapes(self) -> List:
        if self.pack_factor > 1:
            return [(self.row_time, self.row_label)]
        return [(b.time_steps, b.label_steps) for b in self.buckets]

    def batch_plan(self, shuffle: bool, seed: Optional[int]):
        """Partition utterance indices into (bucket_index, indices) batches.
        In packed mode entries are (-1, rows) where rows is a list of
        per-row utterance-index lists."""
        rng = np.random.RandomState(seed if seed is not None else 0)
        if self.pack_factor > 1:
            order = list(range(len(self.metas)))
            if shuffle:
                rng.shuffle(order)
            else:
                # without shuffling, longest-first gives the densest rows
                order.sort(key=lambda i: -self._lengths[i])
            # windowed best-fit: each row starts with the next utterance
            # in (shuffled) order, then greedily pulls the LARGEST
            # still-fitting utterance from a small lookahead window —
            # measured fill ~0.73 (plain greedy) → ~0.95+ while keeping
            # batch composition stochastic under shuffle
            window = 256
            pool = list(reversed(order))       # pop() takes the next
            rows: List[List[int]] = []
            while pool:
                cur = [pool.pop()]
                space = self.row_time - self._lengths[cur[0]]
                while len(cur) < self.pack_factor and pool and space > 0:
                    lo = max(0, len(pool) - window)
                    best, best_len = -1, 0
                    for j in range(len(pool) - 1, lo - 1, -1):
                        t_len = self._lengths[pool[j]]
                        if best_len < t_len <= space:
                            best, best_len = j, t_len
                    if best < 0:
                        break
                    cur.append(pool.pop(best))
                    space -= best_len
                rows.append(cur)
            plan = [(-1, rows[s:s + self.batch_size])
                    for s in range(0, len(rows), self.batch_size)]
            if shuffle:
                rng.shuffle(plan)
            return plan
        plan = []
        for bucket_idx, bucket in enumerate(self.buckets):
            members = list(bucket.member_indices)
            if shuffle:
                rng.shuffle(members)
            for start in range(0, len(members), self.batch_size):
                plan.append((bucket_idx,
                             members[start:start + self.batch_size]))
        if shuffle:
            rng.shuffle(plan)
        return plan

    def _assemble_packed(self, rows: List[List[int]], loader) -> Batch:
        """Assemble one packed batch: rows of utterances back-to-back.

        N = batch_size * pack_factor utterance slots; unused slots have
        utt_sequence_length 0 / target_length 0 and contribute neither
        loss nor gradient (the CTC infeasible-pair path).  The
        per-utterance time index is a flat gather into the row-major
        [B·T] frame axis, clipped to the owning row.

        Slot layout is RANK-MAJOR: each row's utterances are placed
        longest-first, and the k-th longest of row r occupies slot
        ``k·B + r``.  Since the k+1 longest utterances of a row sum to
        ≤ row_time, the rank-k utterance is ≤ row_time/(k+1) frames —
        so the CTC loss can gather rank-k slots at a statically smaller
        width (train/graph.py tiered gather) instead of paying
        N_slots × full-row-T."""
        batch_b, t_row = self.batch_size, self.row_time
        num_slots = batch_b * self.pack_factor
        feats = np.zeros((batch_b, t_row, self.input_dim), dtype=np.float32)
        seq_len = np.zeros((batch_b,), dtype=np.int32)
        reset = np.zeros((batch_b, t_row), dtype=np.float32)
        targets = np.full((num_slots, self.row_label), -1, dtype=np.int32)
        tgt_len = np.zeros((num_slots,), dtype=np.int32)
        utt_seq = np.zeros((num_slots,), dtype=np.int32)
        # default: every slot gathers frame 0 of its OWNING row (slot %
        # B) — harmless for dummy slots (zero-length ⇒ zero loss/grad)
        # and keeps the row-locality contract exact for every slot
        utt_idx = np.broadcast_to(
            (np.arange(num_slots, dtype=np.int32) % batch_b)[:, None]
            * t_row, (num_slots, t_row)).copy()
        # keys is slot-indexed (keys[slot] names the utterance whose
        # targets/tgt_len/utt_* live at that slot; "" for dummy slots)
        # so consumers can zip keys with the per-utterance arrays
        keys: List[str] = [""] * num_slots
        arange_t = np.arange(t_row, dtype=np.int32)
        for row, members in enumerate(rows):
            # longest-first establishes the rank-tier width guarantee
            members = sorted(members, key=lambda i: -self._lengths[i])
            offset = 0
            for rank, idx in enumerate(members):
                slot = rank * batch_b + row
                meta = self.metas[idx]
                want = self._lengths[idx]
                t_len, label_len, key = self._load_into(
                    loader, meta, feats[row, offset:offset + want],
                    targets[slot])
                tgt_len[slot] = label_len
                keys[slot] = key
                assert t_len * (rank + 1) <= t_row, \
                    "rank-%d utterance %s too long for its tier" \
                    % (rank, meta.key)
                reset[row, offset] = 1.0
                utt_seq[slot] = t_len
                utt_idx[slot] = np.minimum(
                    offset + arange_t, t_row - 1) + row * t_row
                offset += t_len
            seq_len[row] = offset
        # pin the rank-major contract at assembly time (host-side,
        # cheap): every slot's indices stay inside its owning row
        # (slot % B) — consumers (train/graph.py row-batched gather)
        # declare and rely on exactly this
        assert (utt_idx // t_row
                == (np.arange(num_slots, dtype=np.int32)
                    % batch_b)[:, None]).all(), \
            "packed slot layout broke the rank-major row-ownership " \
            "contract (data/pipeline.Batch docstring)"
        return Batch(feats, seq_len, targets, tgt_len, keys,
                     reset_mask=reset, utt_time_index=utt_idx,
                     utt_sequence_length=utt_seq)


    def _load_into(self, loader, meta, feats_view, targets_row):
        """Load one utterance into the provided views; returns
        (t_len, label_len, key).  Shared by the packed and unpacked
        assemblers.  The label write CLAMPS to the target row's width,
        so a labeled utterance longer than the label pad cannot overflow
        the buffer (label widths are only guaranteed when the batcher was
        built with label_lengths)."""
        key, mat, labels = loader.load(meta)
        mat = splice_frames(mat, self.left_context, self.right_context)
        mat = subsample_frames(mat, self.subsample)
        t_len = mat.shape[0]
        feats_view[:t_len] = mat
        label_len = 0
        if labels is not None and len(labels):
            label_len = min(len(labels), targets_row.shape[0])
            targets_row[:label_len] = labels[:label_len]
        return t_len, label_len, key

    def assemble(self, bucket_idx: int, indices: List[int],
                 loader) -> Batch:
        """Load, transform and pad a batch given utterance indices (all from
        one bucket).  ``loader`` is a RecordLoader.  In packed mode
        (bucket_idx == -1) ``indices`` is the per-row grouping instead."""
        if bucket_idx == -1:
            return self._assemble_packed(indices, loader)
        bucket = self.buckets[bucket_idx]
        batch_b = self.batch_size
        t_pad, u_pad = bucket.time_steps, bucket.label_steps
        feats = np.zeros((batch_b, t_pad, self.input_dim), dtype=np.float32)
        seq_len = np.zeros((batch_b,), dtype=np.int32)
        targets = np.full((batch_b, u_pad), -1, dtype=np.int32)
        tgt_len = np.zeros((batch_b,), dtype=np.int32)
        keys = []
        for row, idx in enumerate(indices):
            meta = self.metas[idx]
            t_len, label_len, key = self._load_into(
                loader, meta, feats[row], targets[row])
            seq_len[row] = t_len
            tgt_len[row] = label_len
            keys.append(key)
        return Batch(feats, seq_len, targets, tgt_len, keys)


def iterate_batches(batcher: BucketedBatcher,
                    shuffle: bool = False,
                    seed: Optional[int] = None,
                    prefetch: int = 4) -> Iterator[Batch]:
    """Yield one epoch of batches, assembling them on a background thread."""
    plan = batcher.batch_plan(shuffle, seed)
    loader = RecordLoader()

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for bucket_idx, indices in plan:
                if not put(batcher.assemble(bucket_idx, indices, loader)):
                    return
            put(None)
        except BaseException as exc:
            put(exc)
        finally:
            # the PRODUCER owns the loader: it is closed only after the
            # last assemble that uses it
            loader.close()

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # abandonment (early generator exit): signal the producer; it
        # finishes its in-flight assemble, then closes the loader itself
        stop.set()


def iterate_utterances(metas: Sequence[RecordMeta],
                       left_context: int = 0,
                       right_context: int = 0,
                       subsample: int = 0):
    """Streaming single-utterance pipeline for inference (the reference's
    ``create_pipeline_sequential``, nnet/pipeline.py:66-86)."""
    loader = RecordLoader()
    try:
        for meta in metas:
            key, mat, labels = loader.load(meta)
            mat = splice_frames(mat, left_context, right_context)
            mat = subsample_frames(mat, subsample)
            yield key, mat, labels
    finally:
        loader.close()
