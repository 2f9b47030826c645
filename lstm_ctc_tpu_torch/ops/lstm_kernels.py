"""Fused BLSTM layer forward and backward: the wrappers around
``csrc/lstm_fwd.cu`` (K1), ``csrc/lstm_bwd.cu`` (K2) and
``csrc/lstm_bwd_fold.cu`` (K3).

Counterpart of ``lstm_ctc_tpu/ops/lstm_pallas.py`` ``bilstm_dual_scan_fused``
(:694), whose Pallas kernels ``_make_fwd_kernel`` (:57-131) and
``_make_bwd_kernel`` (:134-418) run one layer's whole-sequence recurrence
and its backward for both directions.  The input projection stays one
``torch.matmul`` outside the kernels, as it is an einsum outside the Pallas
kernels there.  In training its gradients (dx, dwx, dbias) are, by
default, autograd's products over the dgates stream K2 emits, as XLA's are
in ``fused_bwd`` (:597-619); with ``fold_dx`` K3 computes them itself from
the dgates its recurrence keeps, as ``fusedx_bwd`` (:651-672) does with
``LSTM_CTC_TPU_LSTM_FOLD_DX=1``.

On a CPU tensor a wrapper runs its plain version
(``models/cells.dual_recurrence``, ``dual_recurrence_backward``,
``dual_recurrence_backward_fold``); on a CUDA tensor it launches its kernel
or raises.  Each kernel runs a cluster of 8 blocks where its 8-block plan
fits and of 16 where only that fits (up to 2048 units, 128 a block), its
weight slices resident in shared memory (bf16; float32 reads them from
L2); a bf16 layer whose slices fit no resident plan (H = P = 1024 without
a projection, H = 2048 with P = 512) takes the streamed plan, 16 blocks
that stream the slices from L2 at every step.  The weights are laid out
for the cluster size its plan gives.  The models ask ``layer_eligible``
first and run a layer the kernels refuse (past 2048 units, a backward with
H or P not divisible by 4, a shape for which K1 or K2 has no launch plan)
through the plain recurrence under autograd.  Any other error of a kernel
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..models import cells
from .route import warn_once

MAX_UNITS = 2048  # hidden units of a layer, at most (16 blocks of 128)
# hidden units a block owns, at most: K1 and K2, and K12 and K13 on 16
# blocks (64 on 8)
LAYER_BLOCK_UNITS = 128
# the forced plans' codes: the resident plan, the streamed plan with half
# of wh's steps resident, with all of them, and with as many as fit
# (``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu`` ``forced``)
PLANS = {"resident": 1, "streamed": 2, "streamed, wh held": 3,
         "streamed, wh held as fits": 4}


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _unplanned(units: int, out_dim: int, has_proj: bool, bf16: bool,
               store_bf16: bool, train: bool):
    """Which of K1 and, with ``train``, K2 has no launch plan for this
    shape, or None: the plans' own arithmetic in the library (each answers
    the blocks a cluster of its plan, negative for the streamed plan, 0 for
    none), no CUDA call, asked once a shape."""
    lib = _build.library()
    if not lib.lstm_fwd_fits(units, out_dim, int(has_proj), int(bf16)):
        return "forward (K1)"
    if train and not lib.lstm_bwd_fits(units, out_dim, int(has_proj),
                                       int(bf16), int(store_bf16)):
        return "backward (K2)"
    return None


def _refusal(device, units: int, out_dim: int, has_proj: bool, dtype,
             train: bool, store_dtype):
    """(reason, message) why the layer kernels refuse this layer, or
    None."""
    if units > MAX_UNITS:
        return ("lstm units", "lstm: a layer of %d units exceeds the CUDA "
                "layer kernels' %d" % (units, MAX_UNITS))
    if train and (units % 4 or out_dim % 4):
        return ("lstm backward width", "lstm: the CUDA layer backward takes "
                "H and P divisible by 4, got H=%d P=%d" % (units, out_dim))
    if torch.device(device).type != "cuda":
        return None
    what = _unplanned(units, out_dim, has_proj, dtype == torch.bfloat16,
                      store_dtype == torch.bfloat16, train)
    if what is None:
        return None
    return ("lstm %s plan" % what, "lstm: the CUDA layer %s has no launch "
            "plan for a %s layer of H=%d P=%d (its threads, products or "
            "shared memory exceed a block's)"
            % (what, str(dtype).split(".")[-1], units, out_dim))


def layer_eligible(device, units: int, out_dim: int, has_proj: bool, dtype,
                   train: bool, store_dtype=torch.bfloat16,
                   warn: bool = False) -> bool:
    """Whether the layer kernels take a BLSTM layer (or ``models/lstm``'s
    two half-batches) of ``units`` cells and ``out_dim`` outputs in the
    compute ``dtype``: K1, and with ``train`` K2 (K3 takes what K2 takes),
    its per-step states in ``store_dtype``.  A function of the shape: at
    most 2048 units; in training H and P divisible by 4; on a CUDA
    ``device``, a launch plan of K1 (and K2), resident or streamed.  With
    ``warn``, a refusal warns once per process for each reason."""
    refusal = _refusal(device, units, out_dim, has_proj, dtype, train,
                       store_dtype)
    if refusal is None:
        return True
    if warn:
        warn_once(refusal[0], refusal[1] + "; using the plain recurrence "
                  "under autograd.")
    return False


def lstm_layer_forward(gx, sequence_length, keep, wh, proj, peep,
                       forget_bias: float, states: bool = False,
                       store_dtype=torch.float32, _plan=None):
    """One BLSTM layer's recurrence over the whole sequence.

    Arguments and return value as ``cells.dual_recurrence``: gx
    ``[T, 2B, 4H]`` f32, sequence_length ``[B]``, keep ``[T, B]`` f32 or
    None, wh ``[2, P, 4H]`` and proj ``[2, H, P]`` (or None) in the
    compute dtype (float32 or bfloat16), peep ``[2, 3, H]`` f32 or None.
    Returns (out ``[T, 2B, P]``, c ``[2B, H]``, h ``[2B, P]``), f32, and
    with ``states`` the per-step carried states c_all ``[T, 2B, H]`` and
    h_all ``[T, 2B, P]`` in ``store_dtype`` (float32 or bfloat16).  The
    weights' cluster layout is made once per weight tensor
    (``cells.derived``).  ``_plan`` = (a name of ``PLANS``, R) forces a
    bf16 launch onto that plan and R, to hold the plans against each other
    (``csrc/lstm_fwd.cu`` ``forced``)."""
    if store_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("store dtype must be float32 or bfloat16, got %s"
                         % store_dtype)
    if gx.device.type == "cpu":
        result = cells.dual_recurrence(gx, sequence_length, keep, wh, proj,
                                       peep, forget_bias, states)
        if states:
            result = result[:3] + tuple(s.to(store_dtype)
                                        for s in result[3:])
        return result
    if gx.device.type != "cuda":
        raise ValueError("lstm_layer_forward: unsupported device %s"
                         % gx.device)
    time_steps, b2, h4 = gx.shape
    batch, num_units = b2 // 2, h4 // 4
    out_dim = proj.shape[2] if proj is not None else num_units
    if gx.dtype != torch.float32 or not gx.is_contiguous() or b2 % 2:
        raise ValueError("gx must be a contiguous float32 [T, 2B, 4H]")
    if wh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % wh.dtype)
    _expect(wh, (2, out_dim, h4), wh.dtype, gx.device, "wh")
    if proj is not None:
        _expect(proj, (2, num_units, out_dim), wh.dtype, gx.device, "proj")
    if peep is not None:
        _expect(peep, (2, 3, num_units), torch.float32, gx.device, "peep")
    if keep is not None:
        _expect(keep, (time_steps, batch), torch.float32, gx.device, "keep")
    lengths = sequence_length.to(device=gx.device,
                                 dtype=torch.int32).contiguous()
    if lengths.shape != (batch,):
        raise ValueError("sequence_length must be [B]")

    lib = _build.library()
    plan = lib.lstm_fwd_fits(num_units, out_dim, int(proj is not None),
                             int(wh.dtype == torch.bfloat16))
    if not plan:
        raise RuntimeError("lstm_fwd: no launch plan for a %s layer of H=%d "
                           "P=%d" % (str(wh.dtype).split(".")[-1], num_units,
                                     out_dim))
    cluster, streamed = abs(plan), plan < 0
    if _plan is not None:
        streamed = _plan[0] != "resident"
    wh_sl, proj_sl = cells.derived(
        [t for t in (wh, proj) if t is not None],
        ("cluster slices", cluster, streamed),
        lambda: _slices(wh, proj, cluster, streamed))
    out = torch.empty(time_steps, b2, out_dim, device=gx.device)
    cfin = torch.empty(b2, num_units, device=gx.device)
    hfin = torch.empty(b2, out_dim, device=gx.device)
    c_all = h_all = None
    if states:
        c_all = torch.empty(time_steps, b2, num_units, device=gx.device,
                            dtype=store_dtype)
        h_all = torch.empty(time_steps, b2, out_dim, device=gx.device,
                            dtype=store_dtype)
    launch = lib.lstm_fwd_bf16 if wh.dtype == torch.bfloat16 \
        else lib.lstm_fwd_f32
    args = [gx.device.index or 0, _ptr(gx), _ptr(lengths), _ptr(keep),
            _ptr(wh_sl), _ptr(proj_sl), _ptr(peep), float(forget_bias),
            time_steps, batch, num_units, out_dim,
            _ptr(out), _ptr(c_all), _ptr(h_all),
            int(store_dtype == torch.bfloat16), _ptr(cfin), _ptr(hfin),
            torch.cuda.current_stream(gx.device).cuda_stream]
    if _plan is not None:
        if wh.dtype != torch.bfloat16:
            raise ValueError("a forced plan is a bf16 launch")
        launch = lib.lstm_fwd_bf16_forced
        args += [PLANS[_plan[0]], int(_plan[1])]
    err = launch(*args)
    _build.check(err, "lstm_fwd")
    lstm_layer_forward.launches += 1
    return (out, cfin, hfin) + ((c_all, h_all) if states else ())


lstm_layer_forward.launches = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _slices(wh, proj, cluster: int, padded: bool = False,
            block_units: int = LAYER_BLOCK_UNITS):
    """The weights as the kernel's cluster blocks own them: block q holds
    hidden units [q·US, (q+1)·US) of all four gates and projection columns
    [q·PS, (q+1)·PS): wh ``[n, P, 4H]`` → ``[n, cluster, P16, 4, US]``,
    proj ``[n, H, P]`` → ``[n, cluster, H16, PS]``, zero-padded (n: the
    directions of a layer, or the layers of a stack).  US is a multiple of
    8 and at most ``block_units`` (K1 and K2: 128; K12 and K13: 128 on 16
    blocks, 64 on 8), PS a multiple
    of 16, P16 and H16 are P and H rounded up to 16, as in
    ``csrc/lstm_fwd.cu`` ``fwd_plan`` (8 or 16 blocks) and
    ``csrc/lstm_cluster.cuh`` ``plan`` (K12: 8 or 16).  With ``padded``
    (the streamed plans), each row of wh's slice is padded by 8 zeros as
    it lies in shared memory, ``[n, cluster, P16, 4·US + 8]``, so that a
    chunk of rows is one bulk copy."""
    n, out_dim, h4 = wh.shape
    units = h4 // 4
    us = _round_up(-(-units // cluster), 8)
    if us > block_units:
        raise ValueError("the kernel takes at most %d units, got %d"
                         % (block_units * cluster, units))
    p16, h16 = _round_up(out_dim, 16), _round_up(units, 16)
    wh_sl = F.pad(wh.reshape(n, out_dim, 4, units),
                  (0, cluster * us - units, 0, 0, 0, p16 - out_dim))
    wh_sl = wh_sl.view(n, p16, 4, cluster, us).permute(0, 3, 1, 2, 4)
    if padded:
        wh_sl = F.pad(wh_sl.reshape(n, cluster, p16, 4 * us), (0, 8))
    if proj is None:
        return wh_sl.contiguous(), None
    ps = _round_up(-(-out_dim // cluster), 16)
    proj_sl = F.pad(proj, (0, cluster * ps - out_dim, 0, h16 - units))
    proj_sl = proj_sl.view(n, h16, cluster, ps).permute(0, 2, 1, 3)
    return wh_sl.contiguous(), proj_sl.contiguous()


def _expect(t, shape, dtype, device, name):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError("%s: expected contiguous %s %s on %s, got %s %s on "
                         "%s" % (name, dtype, tuple(shape), device, t.dtype,
                                 tuple(t.shape), t.device))


def bilstm_dual_scan_fused(fw_params, bw_params, x, x_rev,
                           sequence_length, forget_bias,
                           compute_dtype=None, reset_mask=None):
    """Drop-in for ``cells.bilstm_dual_scan`` through the layer kernel.

    Returns (fw_out [B,T,P], bw_out [B,T,P] reversed, (fw_state,
    bw_state)) with the same semantics (peepholes, forget bias,
    projection, ``dynamic_rnn`` masking, packed-row resets)."""
    gx, wh, proj, peep = cells.layer_inputs(fw_params, bw_params, x, x_rev,
                                            compute_dtype)
    _, keep = cells.step_masks(sequence_length, reset_mask, x.shape[1],
                               x.device)
    out, cfin, hfin = lstm_layer_forward(gx, sequence_length, keep, wh,
                                         proj, peep, forget_bias)
    return cells.split_directions(out, cfin, hfin, x.shape[0])


def lstm_layer_backward(gx, sequence_length, keep, wh, proj, peep,
                        forget_bias: float, c_all, h_all, dout, dcfin, dhfin,
                        store_dtype=torch.float32, steps: bool = False,
                        _plan=None):
    """One BLSTM layer's backward over the whole sequence (K2).

    Arguments and return value as ``cells.dual_recurrence_backward``:
    (dgates ``[T, 2B, 4H]`` in ``store_dtype``, dwh ``[2, P, 4H]``, dproj
    ``[2, H, P]`` or None, dpeep ``[2, 3, H]`` or None), and with
    ``steps`` the cotangents of the carried states entering each step,
    dc_in ``[T, 2B, H]`` and dh_in ``[T, 2B, P]``.  c_all and h_all are
    in ``store_dtype``.  ``_plan`` forces a bf16 launch's plan and R, as
    ``lstm_layer_forward``'s does (``csrc/lstm_bwd.cu`` ``forced``)."""
    if gx.device.type == "cpu":
        return cells.dual_recurrence_backward(
            gx, sequence_length, keep, wh, proj, peep, forget_bias, c_all,
            h_all, dout, dcfin, dhfin, store_dtype, steps)
    dgates, dwh, dproj, dpeep, dc_in, dh_in, _, _ = _backward_launch(
        "lstm_layer_backward", None, gx, sequence_length, keep, wh, proj,
        peep, forget_bias, c_all, h_all, dout, dcfin, dhfin, store_dtype,
        steps, _plan)
    lstm_layer_backward.launches += 1
    result = (dgates, dwh, dproj, dpeep)
    return result + ((dc_in, dh_in) if steps else ())


lstm_layer_backward.launches = 0


def lstm_layer_backward_fold(x2, wx, gx, sequence_length, keep, wh, proj,
                             peep, forget_bias: float, c_all, h_all, dout,
                             dcfin, dhfin, store_dtype=torch.float32,
                             steps: bool = False):
    """One BLSTM layer's backward with its input side folded in (K3).

    Arguments and return value as ``cells.dual_recurrence_backward_fold``:
    x2 ``[2, B, T, D]`` float32 (the layer input and its reverse) and wx
    ``[2, D, 4H]`` in the compute dtype, then K2's arguments.  Returns (dx2
    ``[2, B, T, D]`` in ``store_dtype``, dwx ``[2, D, 4H]``, dbias
    ``[2, 4H]``, dwh, dproj, dpeep) and, with ``steps``, (dgates, dc_in,
    dh_in) after them."""
    if gx.device.type == "cpu":
        return cells.dual_recurrence_backward_fold(
            x2, wx, gx, sequence_length, keep, wh, proj, peep, forget_bias,
            c_all, h_all, dout, dcfin, dhfin, store_dtype, steps)
    dgates, dwh, dproj, dpeep, dc_in, dh_in, folded, _ = _backward_launch(
        "lstm_layer_backward_fold", (x2, wx), gx, sequence_length, keep, wh,
        proj, peep, forget_bias, c_all, h_all, dout, dcfin, dhfin,
        store_dtype, steps)
    lstm_layer_backward_fold.launches += 1
    result = folded + (dwh, dproj, dpeep)
    return result + ((dgates, dc_in, dh_in) if steps else ())


lstm_layer_backward_fold.launches = 0


def _backward_launch(what, fold, gx, sequence_length, keep, wh, proj, peep,
                     forget_bias, c_all, h_all, dout, dcfin, dhfin,
                     store_dtype, steps, plan=None):
    """Launch K2, or K3 when ``fold`` is (x2, wx); K2 on a forced plan and
    R when ``plan`` is given.  Returns (dgates, dwh, dproj, dpeep, dc_in,
    dh_in, (dx2, dwx, dbias) or None, (the out_blk and dout_p stashes) or
    (None, None) without a projection)."""
    if gx.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, gx.device))
    time_steps, b2, h4 = gx.shape
    batch, num_units = b2 // 2, h4 // 4
    out_dim = wh.shape[1]
    if gx.dtype != torch.float32 or not gx.is_contiguous() or b2 % 2:
        raise ValueError("gx must be a contiguous float32 [T, 2B, 4H]")
    if wh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % wh.dtype)
    if num_units % 4 or out_dim % 4:
        raise ValueError("the backward kernel takes H and P divisible by 4, "
                         "got H=%d P=%d" % (num_units, out_dim))
    device = gx.device
    _expect(wh, (2, out_dim, h4), wh.dtype, device, "wh")
    if proj is not None:
        _expect(proj, (2, num_units, out_dim), wh.dtype, device, "proj")
    if peep is not None:
        _expect(peep, (2, 3, num_units), torch.float32, device, "peep")
    if keep is not None:
        _expect(keep, (time_steps, batch), torch.float32, device, "keep")
    _expect(c_all, (time_steps, b2, num_units), store_dtype, device, "c_all")
    _expect(h_all, (time_steps, b2, out_dim), store_dtype, device, "h_all")
    lengths = sequence_length.to(device=device, dtype=torch.int32).contiguous()
    dout = dout.float().contiguous()
    dcfin = dcfin.float().contiguous()
    dhfin = dhfin.float().contiguous()
    _expect(dout, (time_steps, b2, out_dim), torch.float32, device, "dout")
    _expect(dcfin, (b2, num_units), torch.float32, device, "dcfin")
    _expect(dhfin, (b2, out_dim), torch.float32, device, "dhfin")
    if fold is not None:
        x2, wx = fold
        dim = x2.shape[-1]
        _expect(x2, (2, batch, time_steps, dim), torch.float32, device, "x2")
        _expect(wx, (2, dim, h4), wh.dtype, device, "wx")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype)

    lib = _build.library()
    name = "lstm_bwd_fold" if fold else "lstm_bwd"
    layout = lib.lstm_bwd_fits(num_units, out_dim, int(proj is not None),
                               int(wh.dtype == torch.bfloat16),
                               int(store_dtype == torch.bfloat16))
    if not layout:
        raise RuntimeError("%s: no launch plan for a %s layer of H=%d P=%d"
                           % (name, str(wh.dtype).split(".")[-1], num_units,
                              out_dim))
    cluster, streamed = abs(layout), layout < 0
    if plan is not None:
        streamed = plan[0] != "resident"
    wh_sl, proj_rows = _backward_slices(wh, proj, cluster, streamed)
    dgates = empty(time_steps, b2, h4, dtype=store_dtype)
    outb = doutp = dproj = None
    if proj is not None:
        # the dproj product's operands, stashed in the compute dtype
        outb = empty(time_steps, b2, num_units, dtype=wh.dtype)
        doutp = empty(time_steps, b2, out_dim, dtype=wh.dtype)
        dproj = empty(2, num_units, out_dim)
    dc_in = dh_in = None
    if steps:
        dc_in = empty(time_steps, b2, num_units)
        dh_in = empty(time_steps, b2, out_dim)
    dwh = empty(2, out_dim, h4)
    bf16 = wh.dtype == torch.bfloat16
    dpeep = None if peep is None else empty(2, 3, num_units)
    if fold is None:
        scratch = empty(lib.lstm_bwd_scratch_floats(time_steps, batch,
                                                    num_units, out_dim))
    else:
        floats = lib.lstm_bwd_fold_scratch_floats(
            device.index or 0, time_steps, batch, num_units, out_dim, dim,
            int(bf16), int(store_dtype == torch.bfloat16))
        if floats < 0:
            raise RuntimeError("lstm_bwd_fold: the device's SM count cannot "
                               "be read")
        scratch = empty(floats)
    args = [device.index or 0, _ptr(gx), _ptr(lengths), _ptr(keep),
            _ptr(c_all), _ptr(h_all), _ptr(wh_sl), _ptr(proj_rows),
            _ptr(peep), float(forget_bias), _ptr(dout), _ptr(dcfin),
            _ptr(dhfin), time_steps, batch, num_units, out_dim,
            int(store_dtype == torch.bfloat16), _ptr(dgates), _ptr(outb), _ptr(doutp), _ptr(dc_in), _ptr(dh_in), _ptr(dwh),
            _ptr(dproj), _ptr(dpeep), _ptr(scratch),
            torch.cuda.current_stream(device).cuda_stream]
    folded = None
    if plan is not None:
        if not bf16 or fold is not None:
            raise ValueError("a forced plan is a bf16 launch of K2")
        launch = lib.lstm_bwd_bf16_forced
        args += [PLANS[plan[0]], int(plan[1])]
    elif fold is None:
        launch = lib.lstm_bwd_bf16 if bf16 else lib.lstm_bwd_f32
    else:
        folded = (empty(2, batch, time_steps, dim, dtype=store_dtype),
                  empty(2, dim, h4), empty(2, h4))
        args += [_ptr(x2), _ptr(wx), dim] + [_ptr(t) for t in folded]
        launch = lib.lstm_bwd_fold_bf16 if bf16 else lib.lstm_bwd_fold_f32
    _build.check(launch(*args), name)
    return dgates, dwh, dproj, dpeep, dc_in, dh_in, folded, (outb, doutp)


def _proj_rows(proj, cluster: int, padded: bool = False):
    """proj as the backward's cluster blocks own it: block q holds the rows
    of its hidden units [q·US, (q+1)·US), proj ``[n, H, P]`` → ``[n,
    cluster, U16, P16]`` (U16: US rounded up to 16, P16: P rounded up to
    16), zero-padded, as in ``csrc/lstm_bwd.cu`` ``bwd_plan``; with
    ``padded`` (the streamed plan) each row padded by 8 zeros, ``[n,
    cluster, U16, P16 + 8]``."""
    n, units, out_dim = proj.shape
    us = _round_up(-(-units // cluster), 8)
    rows = F.pad(proj, (0, _round_up(out_dim, 16) - out_dim + 8 * padded,
                        0, cluster * us - units))
    rows = rows.view(n, cluster, us, rows.shape[-1])
    return F.pad(rows, (0, 0, 0, _round_up(us, 16) - us)).contiguous()


def _backward_slices(wh, proj, cluster: int, padded: bool = False):
    """(wh slices as K1 holds them, proj rows or None) for K2, made once
    per weight tensor (``cells.derived``); ``padded`` for the streamed
    plan."""
    sources = [t for t in (wh, proj) if t is not None]
    wh_sl = cells.derived(sources, ("cluster slices", cluster, padded),
                          lambda: _slices(wh, proj, cluster, padded))[0]
    if proj is None:
        return wh_sl, None
    return wh_sl, cells.derived([proj], ("proj rows", cluster, padded),
                                lambda: _proj_rows(proj, cluster, padded))


def _config(what, device, batch, units, out_dim, has_proj, dtype,
            at=0) -> dict:
    lib = _build.library()
    ints = [ctypes.c_int() for _ in range(5)]
    longs = [ctypes.c_longlong() for _ in range(3)]
    err = getattr(lib, what)(device.index or 0, batch, units, out_dim,
                             int(has_proj), int(dtype == torch.bfloat16),
                             *[ctypes.byref(v) for v in ints[:4]],
                             ctypes.byref(longs[0]), ctypes.byref(ints[4]),
                             *[ctypes.byref(v) for v in longs[1:]], at)
    _build.check(err, what)
    blocks, rows, clusters, resident, streamed = (v.value for v in ints)
    smem, held, streams = (v.value for v in longs)
    return {"blocks": blocks, "rows": rows, "clusters": clusters,
            "resident": resident, "waves": -(-clusters // max(resident, 1)),
            "smem_bytes": smem, "streamed": bool(streamed),
            "held_bytes": held, "streamed_bytes": streams}


def forward_config(device, batch: int, units: int, out_dim: int,
                   has_proj: bool, dtype, rows: int = 0) -> dict:
    """How K1 launches on ``device`` at this shape, as its launcher
    chooses: ``blocks`` a cluster (8 or 16), ``rows`` (batch rows a
    cluster, R), ``clusters``, ``resident`` (clusters resident at once, the
    occupancy API's answer), ``waves``, ``smem_bytes`` (shared memory a
    block), ``streamed`` (the streamed plan or not), and a block's weight
    bytes ``held_bytes`` in shared memory and ``streamed_bytes`` read from
    L2 at every step.  With ``rows`` on the streamed plan: the launch at
    that R, as a forced launch (``_plan`` "streamed, wh held as fits")
    takes it."""
    return _config("lstm_fwd_config", device, batch, units, out_dim,
                   has_proj, dtype, rows)


def backward_config(device, batch: int, units: int, out_dim: int,
                    has_proj: bool, dtype, rows: int = 0) -> dict:
    """How K2 launches on ``device`` at this shape (its per-step states in
    ``dtype``), as ``forward_config`` says K1's."""
    return _config("lstm_bwd_config", device, batch, units, out_dim,
                   has_proj, dtype, rows)


# the phases the streamed K1's and K2's clock64 stamps sum (csrc/lstm_fwd.cu
# c_fwd_stamps, csrc/lstm_bwd_streamed.cu c_bwd_stamps)
STAMP_PHASES = {
    "forward": ("wait for h", "gate product", "cell phase and hand-off",
                "wait for the cell output", "projection product",
                "masking and hand-off"),
    "backward": ("stashes and dout_blk", "cell phase",
                 "loads and the pass over wh", "first cluster barrier",
                 "owners' sums and dout_p", "second cluster barrier")}


def stamp_phases(which: str, stamps) -> None:
    """Point the streamed K1's (``which`` "forward") or K2's ("backward")
    clock64 stamps at ``stamps``, a CUDA int64 tensor of 1 + 6 (at a
    launch's end: its steps, then each of STAMP_PHASES' cycles summed over
    the steps by thread 0 of the first block of the first cluster), or at
    nothing (None): ``scripts/layer_stamps.py``'s switch, off in every
    other launch."""
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() != 7
                               or stamps.device.type != "cuda"):
        raise ValueError("stamps: expected a CUDA int64 tensor of 7")
    name = "lstm_fwd_stamps" if which == "forward" else "lstm_bwd_stamps"
    _build.check(getattr(_build.library(), name)(_ptr(stamps)), name)


class _LstmLayer(torch.autograd.Function):
    """One BLSTM layer under autograd: K1 with its per-step states stored
    in the store dtype, and K2 for the backward."""

    @staticmethod
    def forward(ctx, gx, wh, proj, peep, sequence_length, keep,
                forget_bias, store_dtype):
        out, cfin, hfin, c_all, h_all = lstm_layer_forward(
            gx, sequence_length, keep, wh, proj, peep, forget_bias,
            states=True, store_dtype=store_dtype)
        ctx.save_for_backward(gx, wh, proj, peep, sequence_length, keep,
                              c_all, h_all)
        ctx.forget_bias, ctx.store_dtype = forget_bias, store_dtype
        return out, cfin, hfin

    @staticmethod
    def backward(ctx, dout, dcfin, dhfin):
        gx, wh, proj, peep, sequence_length, keep, c_all, h_all = \
            ctx.saved_tensors
        dgates, dwh, dproj, dpeep = lstm_layer_backward(
            gx, sequence_length, keep, wh, proj, peep, ctx.forget_bias,
            c_all, h_all, dout, dcfin, dhfin, store_dtype=ctx.store_dtype)
        return (dgates.float(), dwh.to(wh.dtype),
                None if dproj is None else dproj.to(proj.dtype), dpeep,
                None, None, None, None)


class _LstmLayerFold(torch.autograd.Function):
    """One BLSTM layer with its input projection under autograd (``fusedx``,
    ``lstm_pallas.py`` :634-675): the projection as one torch product, K1
    with its per-step states stored in the store dtype, and K3 for the
    whole backward, the input side included."""

    @staticmethod
    def forward(ctx, x2, wx, bias, wh, proj, peep, sequence_length, keep,
                forget_bias, store_dtype):
        gx = cells.input_projection(x2, wx, bias)
        out, cfin, hfin, c_all, h_all = lstm_layer_forward(
            gx, sequence_length, keep, wh, proj, peep, forget_bias,
            states=True, store_dtype=store_dtype)
        ctx.save_for_backward(x2, wx, gx, wh, proj, peep, sequence_length,
                              keep, c_all, h_all)
        ctx.forget_bias, ctx.store_dtype = forget_bias, store_dtype
        return out, cfin, hfin

    @staticmethod
    def backward(ctx, dout, dcfin, dhfin):
        (x2, wx, gx, wh, proj, peep, sequence_length, keep, c_all,
         h_all) = ctx.saved_tensors
        dx2, dwx, dbias, dwh, dproj, dpeep = lstm_layer_backward_fold(
            x2, wx, gx, sequence_length, keep, wh, proj, peep,
            ctx.forget_bias, c_all, h_all, dout, dcfin, dhfin,
            store_dtype=ctx.store_dtype)
        return (dx2.to(x2.dtype), dwx.to(wx.dtype), dbias, dwh.to(wh.dtype),
                None if dproj is None else dproj.to(proj.dtype), dpeep,
                None, None, None, None)


def bilstm_dual_scan_train(fw_params, bw_params, x, x_rev, sequence_length,
                           forget_bias, compute_dtype=None, reset_mask=None,
                           store_dtype=torch.bfloat16, fold_dx: bool = False):
    """``bilstm_dual_scan_fused`` under autograd: the same forward through
    K1, differentiable through K2, or with ``fold_dx`` through K3, which
    also computes the input side (dx, dwx, dbias; ``lstm_pallas``
    ``LSTM_CTC_TPU_LSTM_FOLD_DX``).  ``store_dtype`` is the precision of
    the per-step states K1 keeps for the backward, of the dgates stream K2
    emits and of the dx K3 emits (``lstm_pallas`` ``store_dtype``)."""
    _, keep = cells.step_masks(sequence_length, reset_mask, x.shape[1],
                               x.device)
    if fold_dx:
        cdt = compute_dtype or x.dtype
        wx, bias = cells.input_weights(fw_params, bw_params, cdt)
        wh, proj, peep = cells.recurrent_weights(fw_params, bw_params, cdt)
        out, cfin, hfin = _LstmLayerFold.apply(
            torch.stack([x, x_rev]), wx, bias, wh, proj, peep,
            sequence_length, keep, float(forget_bias), store_dtype)
    else:
        gx, wh, proj, peep = cells.layer_inputs(fw_params, bw_params, x,
                                                x_rev, compute_dtype)
        out, cfin, hfin = _LstmLayer.apply(gx, wh, proj, peep,
                                           sequence_length, keep,
                                           float(forget_bias), store_dtype)
    return cells.split_directions(out, cfin, hfin, x.shape[0])
