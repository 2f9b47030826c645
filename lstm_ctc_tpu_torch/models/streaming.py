"""Streaming (chunked) inference for the unidirectional LSTM models.

Counterpart of ``lstm_ctc_tpu/models/streaming.py``.  A
``StreamingSession`` takes raw feature frames in chunks of any size and
emits CTC logits as they become available, equal to the whole-utterance
forward:

  * the splice context is carried across chunk boundaries (left context
    from earlier frames; the right context holds a row back until its
    future frames arrive, or the utterance ends);
  * the subsample phase is kept, so the rows are the offline ``floor(T/n)``
    selection (``host/data/pipeline.py``);
  * each layer's (c, h) is carried from chunk to chunk; a chunk is always
    ``chunk_size`` model rows, its short tail padded and masked by the
    sequence length.

The chunk step runs the stack kernel with the carried states
(``models/lstm.stack_layers``).  Only causal models stream (``lstm``,
``cudnnlstm``); a ``blstm`` needs the whole utterance.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .blstm import _compute_dtype, _store_dtype
from .lstm import _dims, _residual_flags, apply_bn_eval, bn_affine, stack_layers
from .moe import apply_moe


class StreamingSession:
    """Stateful chunk-by-chunk forward for one utterance at a time (batch
    1), on the device the parameters lie on."""

    def __init__(self, params: Dict, net_state: Dict, config: Dict,
                 chunk_size: int = 32):
        if config["nnet_type"] not in ("lstm", "cudnnlstm"):
            raise ValueError(
                "streaming needs a causal model (lstm/cudnnlstm), got %s"
                % config["nnet_type"])
        self.params = params
        self.net_state = net_state
        self.config = config
        self.chunk_size = chunk_size
        self.device = params["layers"][0]["wx"].device
        self.left = config.get("left_context", 0) or 0
        self.right = config.get("right_context", 0) or 0
        self.subsample = config.get("subsample", 0) or 0
        self._raw_buffer: Optional[np.ndarray] = None
        self._next_raw = 0          # next raw-frame index to consider
        self._states: Optional[List[Tuple]] = None

    def reset(self) -> None:
        """Clear the per-utterance state: one session serves a whole
        archive."""
        self._raw_buffer = None
        self._next_raw = 0
        self._states = None

    def _model_chunk(self, states, x, seq_len):
        """The model over one padded chunk: x ``[1, chunk, D]`` → (logits
        ``[1, chunk, V]``, the layers' (c, h) after it)."""
        config, params = self.config, self.params
        dims = _dims(config)
        cdt = _compute_dtype(config, x.device)
        lstm = config["nnet_type"] == "lstm"
        use_bn = dims["use_bn"] and lstm
        affine = None
        if use_bn:
            x = apply_bn_eval(params["bn_in"], self.net_state["bn_in"], x)
            affine = bn_affine(params["bn"], self.net_state["bn"])
        res_flags = _residual_flags(dims) if lstm \
            else [False] * dims["num_layers"]
        out, new_states = stack_layers(
            params["layers"], x, seq_len, res_flags, cdt, _store_dtype(config),
            affine=affine, initial_states=states)
        flat = out.reshape(-1, out.shape[-1])
        if dims["num_experts"] > 0:
            y = apply_moe(params["moe"], flat, dims["num_experts"],
                          dims["moe_temp"], compute_dtype=cdt)
        else:
            y = flat @ params["head"]["w"] + params["head"]["b"]
        return y.reshape(1, -1, dims["num_targets"]), new_states

    def _init_states(self) -> List[Tuple]:
        states = []
        for cell in self.params["layers"]:
            units = cell["bias"].shape[0] // 4
            out_dim = cell["proj"].shape[1] if "proj" in cell else units
            states.append((torch.zeros(1, units, device=self.device),
                           torch.zeros(1, out_dim, device=self.device)))
        return states

    def _spliceable_rows(self, flush: bool) -> np.ndarray:
        """Spliced and subsampled rows that can be emitted now."""
        buf = self._raw_buffer
        dim = (buf.shape[1] if buf is not None else 0) * \
            (1 + self.left + self.right)
        if buf is None:
            return np.zeros((0, dim), np.float32)
        total = buf.shape[0]
        factor = self.subsample if self.subsample and self.subsample > 1 \
            else 1
        rows = []
        t = self._next_raw
        while t < total:
            if t % factor != 0:
                t += 1
                continue
            if flush and factor > 1 and t + factor > total:
                break  # offline keeps floor(T/n) rows: t must be <= T-n
            if not flush and t + self.right >= total:
                break  # needs future frames (edge clamp only at flush)
            lo = max(0, t - self.left)
            hi = min(total - 1, t + self.right)
            parts = []
            if self.left - (t - lo):
                parts.extend([buf[lo:lo + 1]] * (self.left - (t - lo)))
            parts.append(buf[lo:hi + 1])
            if self.right - (hi - t):
                parts.extend([buf[hi:hi + 1]] * (self.right - (hi - t)))
            rows.append(np.concatenate(parts, axis=0).reshape(-1))
            t += 1
            self._next_raw = t
        if not rows:
            return np.zeros((0, dim), np.float32)
        return np.stack(rows).astype(np.float32)

    def process(self, frames: Optional[np.ndarray],
                flush: bool = False) -> np.ndarray:
        """Feed raw feature frames ``[N, D]``; returns the logits that
        became available ``[M, V]``.  Call once more with ``flush=True`` at
        the utterance's end."""
        if self._states is None:
            self._states = self._init_states()
        if frames is not None and len(frames):
            frames = np.asarray(frames, np.float32)
            self._raw_buffer = frames if self._raw_buffer is None else \
                np.concatenate([self._raw_buffer, frames], axis=0)
        ready = self._spliceable_rows(flush)
        if ready.shape[0] == 0:
            return np.zeros((0, self.config["num_targets"]), np.float32)
        outputs = []
        pos = 0
        with torch.inference_mode():
            while pos < ready.shape[0]:
                chunk = ready[pos:pos + self.chunk_size]
                true_len = chunk.shape[0]
                if true_len < self.chunk_size:
                    chunk = np.concatenate(
                        [chunk, np.zeros((self.chunk_size - true_len,
                                          chunk.shape[1]), np.float32)])
                logits, self._states = self._model_chunk(
                    self._states,
                    torch.from_numpy(chunk[None]).to(self.device),
                    torch.full((1,), true_len, dtype=torch.int32,
                               device=self.device))
                outputs.append(logits[0, :true_len].cpu().numpy())
                pos += true_len
        return np.concatenate(outputs, axis=0)
