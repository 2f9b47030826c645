"""CTC alpha and beta recursions: the wrappers around ``csrc/ctc_dp.cu``.

Counterparts of ``lstm_ctc_tpu/ops/ctc_pallas.py`` ``alpha_pallas`` (:120)
and ``beta_pallas`` (:168), whose Pallas kernels ``_alpha_kernel``
(:46-75) and ``_beta_kernel`` (:78-105) run the whole time loop of the
log-space DP over the 2U+1 lattice.  ``alpha_reference`` and
``beta_reference`` are the plain versions: the scans of
``lstm_ctc_tpu/ops/ctc.py`` (:211-225 and :290-306) in PyTorch.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Masks are bool tensors.  The kernels take
lattices of at most ``MAX_LATTICE`` positions; ``ops/ctc`` asks
``dp_eligible`` first and runs the plain versions past that, as the
reference runs its scan when the lattice leaves Pallas.
"""

from __future__ import annotations

import torch

from .. import _build
from .route import warn_once

NEG_INF = -1e30
MAX_LATTICE = 1024  # positions a lattice row, at most (csrc/ctc_dp.cu)


def dp_eligible(width: int, warn: bool = False) -> bool:
    """Whether K10 and K11 take a lattice of ``width`` positions; with
    ``warn``, a refusal warns once per process (``route.warn_once``)."""
    if width <= MAX_LATTICE:
        return True
    if warn:
        warn_once("ctc lattice", "ctc_loss: a lattice of S=%d positions "
                  "exceeds the CUDA DP kernels' %d; using the plain "
                  "recursion. Reduce the max label length to stay on the "
                  "kernel path." % (width, MAX_LATTICE))
    return False


def _log3sum(a, b, c):
    """logsumexp of three terms, NEG_INF-safe (``ctc._log3sum``)."""
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return torch.where(m <= NEG_INF * 0.5, torch.full_like(out, NEG_INF), out)


def _shift(x, amount):
    """x moved ``amount`` places along the last axis (right if positive),
    NEG_INF filling the vacated places (all of them on a row shorter than
    the move)."""
    width = x.shape[-1]
    k = min(abs(amount), width)
    pad = x.new_full(x.shape[:-1] + (k,), NEG_INF)
    if amount > 0:
        return torch.cat([pad, x[..., :width - k]], dim=-1)
    return torch.cat([x[..., k:], pad], dim=-1)


def alpha_reference(lp_ext, time_mask, valid, can_skip, alpha0):
    """lp_ext ``[T, N, S]`` f32, time_mask ``[T, N]``, valid / can_skip
    ``[N, S]`` (bool), alpha0 ``[N, S]`` → alpha at every step ``[T, N, S]``
    (row 0 is alpha0; a row stays frozen where time_mask is false)."""
    neg = torch.full_like(alpha0, NEG_INF)
    alpha = alpha0
    rows = [alpha]
    for t in range(1, lp_ext.shape[0]):
        summed = _log3sum(alpha, _shift(alpha, 1),
                          torch.where(can_skip, _shift(alpha, 2), neg))
        new = torch.where(valid, summed + lp_ext[t], neg)
        alpha = torch.where(time_mask[t][:, None], new, alpha)
        rows.append(alpha)
    return torch.stack(rows)


def beta_reference(lp_ext, time_mask, is_last, valid, skip_from, final_mask):
    """Reverse-time beta' (emission included), started at each row's last
    frame (``is_last`` ``[T, N]``) from ``final_mask`` ``[N, S]``; returns
    ``[T, N, S]`` in forward time order."""
    neg = torch.full_like(lp_ext[0], NEG_INF)
    beta = neg
    rows = []
    for t in range(lp_ext.shape[0] - 1, -1, -1):
        lp = lp_ext[t]
        init = torch.where(final_mask & valid, lp, neg)
        moved = _log3sum(beta, _shift(beta, -1),
                         torch.where(skip_from, _shift(beta, -2), neg))
        new = torch.where(valid, moved + lp, neg)
        new = torch.where(is_last[t][:, None], init, new)
        beta = torch.where(time_mask[t][:, None], new, beta)
        rows.append(beta)
    return torch.stack(rows[::-1])


def _check(lp_ext, masks, name):
    if lp_ext.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, lp_ext.device))
    if lp_ext.dtype != torch.float32 or lp_ext.dim() != 3 \
            or not lp_ext.is_contiguous():
        raise ValueError("%s: lp_ext must be a contiguous float32 [T, N, S]"
                         % name)
    steps, slots, width = lp_ext.shape
    if not dp_eligible(width):
        raise ValueError("%s: the kernel takes lattices of at most %d "
                         "positions, got %d" % (name, MAX_LATTICE, width))
    for mask, shape in masks:
        if (mask.dtype != torch.bool or tuple(mask.shape) != shape
                or mask.device != lp_ext.device or not mask.is_contiguous()):
            raise ValueError("%s: masks must be contiguous bool %s on %s"
                             % (name, shape, lp_ext.device))
    return steps, slots, width


def ctc_alpha(lp_ext, time_mask, valid, can_skip, alpha0):
    """Alpha at every step through kernel K10; arguments and result as
    ``alpha_reference``."""
    if lp_ext.device.type == "cpu":
        return alpha_reference(lp_ext, time_mask, valid, can_skip, alpha0)
    ns = (lp_ext.shape[1], lp_ext.shape[2])
    steps, slots, width = _check(
        lp_ext, [(time_mask, lp_ext.shape[:2]), (valid, ns), (can_skip, ns)],
        "ctc_alpha")
    alpha0 = alpha0.float().contiguous()
    if tuple(alpha0.shape) != ns or alpha0.device != lp_ext.device:
        raise ValueError("ctc_alpha: alpha0 must be [N, S] on %s"
                         % lp_ext.device)
    out = torch.empty_like(lp_ext)
    err = _build.library().ctc_alpha(
        lp_ext.device.index or 0, lp_ext.data_ptr(), time_mask.data_ptr(),
        valid.data_ptr(), can_skip.data_ptr(), alpha0.data_ptr(), steps,
        slots, width, out.data_ptr(),
        torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, "ctc_alpha")
    ctc_alpha.launches += 1
    return out


ctc_alpha.launches = 0


def ctc_beta(lp_ext, time_mask, is_last, valid, skip_from, final_mask):
    """Beta' at every step through kernel K11; arguments and result as
    ``beta_reference``."""
    if lp_ext.device.type == "cpu":
        return beta_reference(lp_ext, time_mask, is_last, valid, skip_from,
                              final_mask)
    ns = (lp_ext.shape[1], lp_ext.shape[2])
    steps, slots, width = _check(
        lp_ext, [(time_mask, lp_ext.shape[:2]), (is_last, lp_ext.shape[:2]),
                 (valid, ns), (skip_from, ns), (final_mask, ns)],
        "ctc_beta")
    out = torch.empty_like(lp_ext)
    err = _build.library().ctc_beta(
        lp_ext.device.index or 0, lp_ext.data_ptr(), time_mask.data_ptr(),
        is_last.data_ptr(), valid.data_ptr(), skip_from.data_ptr(),
        final_mask.data_ptr(), steps, slots, width, out.data_ptr(),
        torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, "ctc_beta")
    ctc_beta.launches += 1
    return out


ctc_beta.launches = 0
