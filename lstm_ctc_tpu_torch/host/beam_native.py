"""ctypes bridge to the native CTC prefix beam search.

The port's copy of ``lstm_ctc_tpu/ops/beam_native.py``: prefix beam search
over log-posteriors in ``libctc_beam.so`` (``native/src/ctc_beam.cc``),
which ``lstm_ctc_tpu_torch._native`` builds at first use.  The Python
implementation in ``host.decode`` is the semantic specification;
``LSTM_CTC_TPU_NATIVE_BEAM=0`` selects it.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Optional

import numpy as np


@functools.lru_cache(maxsize=None)
def _library():
    if os.environ.get("LSTM_CTC_TPU_NATIVE_BEAM", "1") == "0":
        return None
    from .. import _native
    built = _native.ensure_built(["libctc_beam.so"])
    lib = ctypes.CDLL(os.path.join(built["dir"], "libctc_beam.so"))
    lib.ctc_beam_search.restype = ctypes.c_int
    lib.ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # log_probs [T, V]
        ctypes.c_int, ctypes.c_int,       # T, V
        ctypes.c_int, ctypes.c_int,       # beam_width, blank_id
        ctypes.c_int, ctypes.c_int,       # top_paths, topk_per_frame
        ctypes.POINTER(ctypes.c_int32),   # out_labels
        ctypes.POINTER(ctypes.c_int32),   # out_lens
        ctypes.c_int,                     # max_labels
    ]
    return lib


def available() -> bool:
    """Whether the native search is selected (building it if need be)."""
    return _library() is not None


def beam_search_decode_native(log_probs: np.ndarray,
                              beam_width: int = 10,
                              blank_id: Optional[int] = None,
                              top_paths: int = 1,
                              topk_per_frame: Optional[int] = None
                              ) -> List[List[int]]:
    """Native prefix beam search; same contract as
    ``host.decode.beam_search_decode`` (including its default per-frame
    class pruning of max(2*beam_width, 8))."""
    lib = _library()
    if lib is None:
        raise RuntimeError("the native beam search is disabled "
                           "(LSTM_CTC_TPU_NATIVE_BEAM=0)")
    lp = np.ascontiguousarray(np.asarray(log_probs, dtype=np.float32))
    num_frames, num_classes = lp.shape
    if blank_id is None:
        blank_id = num_classes - 1
    if topk_per_frame is None:
        topk_per_frame = max(beam_width * 2, 8)
    max_labels = max(1, top_paths * num_frames)
    out_labels = np.empty(max_labels, dtype=np.int32)
    out_lens = np.empty(max(1, top_paths), dtype=np.int32)
    n = lib.ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_frames, num_classes, int(beam_width), int(blank_id),
        int(top_paths), int(topk_per_frame),
        out_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_labels)
    if n < 0:
        raise RuntimeError("ctc_beam_search failed (invalid args or "
                           "output capacity)")
    paths, off = [], 0
    for i in range(n):
        length = int(out_lens[i])
        paths.append([int(v) for v in out_labels[off:off + length]])
        off += length
    return paths
