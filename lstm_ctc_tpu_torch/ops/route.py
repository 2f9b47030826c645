"""The warnings of the routes that send a shape the kernels refuse to the
plain versions, before any launch, as the reference sends such shapes to
XLA (``lstm_ctc_tpu/ops/ctc.py`` ``_warn_scan_fallback`` :43-53 warns once
when its lattice leaves Pallas).  One warning per process per reason."""

from __future__ import annotations

import warnings

_warned = set()


def warn_once(reason: str, message: str) -> None:
    """Warn with ``message`` the first time ``reason`` is given in this
    process (pointing at the caller of the predicate that refused)."""
    if reason not in _warned:
        _warned.add(reason)
        warnings.warn(message, stacklevel=4)
