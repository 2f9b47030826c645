"""LSTM cell primitives: parameter init, the plain unidirectional scan, the
plain dual-direction scan and its backward, dropout.

Counterpart of ``lstm_ctc_tpu/models/cells.py``.  Semantics are TF1's
``LSTMCell`` as the reference uses it: optional diagonal peepholes, optional
output projection, a forget-gate bias added at run time, TF gate order
(i, j, f, o) and ``dynamic_rnn`` masking (outputs are zero past
``sequence_length`` and the carried state freezes there).

``dual_recurrence``, ``dual_recurrence_backward`` and
``dual_recurrence_backward_fold`` are the plain PyTorch versions of the
BLSTM layer kernels (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``,
``csrc/lstm_bwd_fold.cu``): the CPU path, and the references the kernels
are held to on the card.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch


def glorot_uniform(generator: torch.Generator, shape, device="cpu"):
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * limit) - limit).to(device)


def truncated_normal(generator: torch.Generator, shape, stddev,
                     device="cpu"):
    """Normal(0, stddev) truncated to ±2 stddev, by inverting the CDF (as
    ``jax.random.truncated_normal`` does)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    return (stddev * z.clamp(-2.0, 2.0)).to(torch.float32).to(device)


def init_lstm_cell(generator: torch.Generator,
                   input_dim: int,
                   num_units: int,
                   num_proj: Optional[int] = None,
                   use_peepholes: bool = False,
                   device="cpu") -> Dict:
    """Parameters for one LSTM cell.  The TF cell's single ``[D+P, 4H]``
    kernel is split into input (``wx``) and recurrent (``wh``) halves so
    the input half can be applied to the whole sequence at once."""
    out_dim = num_proj if num_proj else num_units
    kernel = glorot_uniform(generator, (input_dim + out_dim, 4 * num_units),
                            device)
    params = {
        "wx": kernel[:input_dim].clone(),
        "wh": kernel[input_dim:].clone(),
        "bias": torch.zeros(4 * num_units, device=device),
    }
    if use_peepholes:
        for name in ("w_i_diag", "w_f_diag", "w_o_diag"):
            params[name] = glorot_uniform(generator, (num_units,), device)
    if num_proj:
        params["proj"] = glorot_uniform(generator, (num_units, num_proj),
                                        device)
    return params


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``dtype`` and the products
    summed in float32 — the arithmetic of the kernels (and of JAX's
    ``preferred_element_type=float32``)."""
    if dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


_DERIVED: Dict = {}


def derived(sources: Sequence[torch.Tensor], tag, build: Callable):
    """``build()``, made once and kept for as long as every tensor of
    ``sources`` lives and is not modified in place: the weights in the
    kernels' layout are made once per model, not once per batch.

    ``tag`` tells apart what is made from the same sources.  ``build``
    must return new tensors, never one of ``sources`` (an entry holding its
    own source would never be dropped).  An inference tensor keeps no
    version counter and is taken as unchanged."""
    key = (tag, torch.is_inference_mode_enabled()) + tuple(
        id(t) for t in sources)
    versions = tuple(None if t.is_inference() else t._version
                     for t in sources)
    hit = _DERIVED.get(key)
    if hit is not None and hit[1] == versions and all(
            ref() is t for ref, t in zip(hit[0], sources)):
        return hit[2]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, k=key: _DERIVED.pop(k, None))
                 for t in sources)
    _DERIVED[key] = (refs, versions, value)
    return value


def recurrent_weights(fw_params: Dict, bw_params: Dict, compute_dtype):
    """``(wh, proj, peep)`` of one layer, both directions stacked: wh
    ``[2, P, 4H]`` and proj ``[2, H, P]`` (or None) in the compute dtype,
    peep ``[2, 3, H]`` float32 (i, f, o diagonals; or None).  Made once per
    model and dtype (``derived``)."""
    diag = ("w_i_diag", "w_f_diag", "w_o_diag")
    sources = [p[n] for n in ("wh", "proj") + diag
               for p in (fw_params, bw_params) if n in p]

    def build():
        pair = (fw_params, bw_params)
        wh = torch.stack([p["wh"] for p in pair]).to(compute_dtype)
        proj = None
        if "proj" in fw_params:
            proj = torch.stack([p["proj"] for p in pair]).to(compute_dtype)
            proj = proj.contiguous()
        peep = None
        if "w_i_diag" in fw_params:
            peep = torch.stack([torch.stack([p[n] for n in diag])
                                for p in pair]).float().contiguous()
        return wh.contiguous(), proj, peep

    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        # under autograd the stack and cast belong to the graph; a copy
        # kept from another step would cut the weights off from it
        return build()
    return derived(sources, ("recurrent", compute_dtype), build)


def layer_inputs(fw_params: Dict, bw_params: Dict, x, x_rev,
                 compute_dtype=None):
    """Everything the layer recurrence reads, in the kernel's layout.

    Returns ``(gx, wh, proj, peep)``: gx ``[T, 2B, 4H]`` float32 (the
    input projection of both directions, forward rows first), and the
    weights as ``recurrent_weights`` returns them."""
    cdt = compute_dtype or x.dtype
    wx, bias = input_weights(fw_params, bw_params, cdt)
    gx = input_projection(torch.stack([x, x_rev]), wx, bias)
    return (gx,) + recurrent_weights(fw_params, bw_params, cdt)


def input_weights(fw_params: Dict, bw_params: Dict, compute_dtype):
    """``(wx, bias)`` of one layer, both directions stacked: wx
    ``[2, D, 4H]`` in the compute dtype, bias ``[2, 4H]`` float32."""
    wx = torch.stack([fw_params["wx"], bw_params["wx"]]).to(compute_dtype)
    bias = torch.stack([fw_params["bias"], bw_params["bias"]]).float()
    return wx, bias


def input_projection(x2, wx, bias):
    """gx ``[T, 2B, 4H]`` float32, forward rows first: x2 ``[2, B, T, D]``
    (the layer input and its reverse) times wx ``[2, D, 4H]`` in wx's
    dtype, plus bias ``[2, 4H]``."""
    _, batch, time_steps, dim = x2.shape
    h4 = wx.shape[2]
    # one large GEMM for the whole sequence, outside the recurrence
    gx = torch.matmul(x2.to(wx.dtype).reshape(2, batch * time_steps, dim),
                      wx).float()
    gx = gx.reshape(2, batch, time_steps, h4) + bias[:, None, None, :]
    return gx.permute(2, 0, 1, 3).reshape(time_steps, 2 * batch,
                                          h4).contiguous()


def step_masks(sequence_length, reset_mask, time_steps, device):
    """``(valid [T, B], keep [T, B] or None)`` float32: valid is 1 before
    ``sequence_length``; keep is 0 where a packed segment starts (the
    carried state is zeroed there)."""
    t = torch.arange(time_steps, device=device)[:, None]
    valid = (t < sequence_length.to(device)[None, :]).float()
    keep = None
    if reset_mask is not None:
        keep = (1.0 - reset_mask.to(device).float().t()).contiguous()
    return valid, keep


def _dual_step(gx_t, keep_t, valid_t, c, h, wh, proj, peep,
               forget_bias: float):
    """One step of both directions, on leading dims ``[..., 2, B]``: gx_t
    ``[..., 2, B, 4H]``; keep_t (or None) and valid_t ``[..., 1, B, 1]``;
    c, h the carried states.  Returns (out, c, h) after masking."""
    num_units = c.shape[-1]
    cdt = wh.dtype
    if keep_t is not None:
        c = keep_t * c
        h = keep_t * h
    gates = gx_t + matmul_f32(h, wh, cdt)
    i, j, f, o = gates.split(num_units, dim=-1)
    if peep is not None:
        i = i + peep[:, 0, None, :] * c
        f = f + peep[:, 1, None, :] * c
    c_new = (torch.sigmoid(f + forget_bias) * c
             + torch.sigmoid(i) * torch.tanh(j))
    if peep is not None:
        o = o + peep[:, 2, None, :] * c_new
    out = torch.sigmoid(o) * torch.tanh(c_new)
    if proj is not None:
        out = matmul_f32(out, proj, cdt)
    m = valid_t
    return m * out, m * c_new + (1.0 - m) * c, m * out + (1.0 - m) * h


def _step_views(gx, sequence_length, keep):
    time_steps, b2, h4 = gx.shape
    valid, _ = step_masks(sequence_length, None, time_steps, gx.device)
    keep = None if keep is None else keep.view(time_steps, 1, b2 // 2, 1)
    return (gx.view(time_steps, 2, b2 // 2, h4), keep,
            valid.view(time_steps, 1, b2 // 2, 1))


def dual_recurrence(gx, sequence_length, keep, wh, proj, peep,
                    forget_bias: float, states: bool = False):
    """Plain version of the BLSTM layer kernel.

    gx ``[T, 2B, 4H]`` f32; sequence_length ``[B]``; keep ``[T, B]`` or
    None; wh, proj, peep as ``layer_inputs`` returns them.  Returns out
    ``[T, 2B, P]`` f32 (zero past each length), c ``[2B, H]``, h ``[2B, P]``
    (the final carried states) and, with ``states``, the carried states
    after every step, c_all ``[T, 2B, H]`` and h_all ``[T, 2B, P]``."""
    time_steps, b2, h4 = gx.shape
    batch, num_units = b2 // 2, h4 // 4
    out_dim = proj.shape[2] if proj is not None else num_units
    gx4, keep4, valid4 = _step_views(gx, sequence_length, keep)
    c = gx.new_zeros(2, batch, num_units)
    h = gx.new_zeros(2, batch, out_dim)
    outs, cs, hs = [], [], []
    for t in range(time_steps):
        out, c, h = _dual_step(gx4[t], None if keep4 is None else keep4[t],
                               valid4[t], c, h, wh, proj, peep, forget_bias)
        outs.append(out)
        if states:
            cs.append(c)
            hs.append(h)
    result = (torch.stack(outs).reshape(time_steps, b2, out_dim),
              c.reshape(b2, num_units), h.reshape(b2, out_dim))
    if states:
        result += (torch.stack(cs).reshape(time_steps, b2, num_units),
                   torch.stack(hs).reshape(time_steps, b2, out_dim))
    return result


def replay_steps(gx, sequence_length, keep, wh, proj, peep,
                 forget_bias: float, c_all, h_all):
    """Every step of the plain recurrence at once, each started from the
    carried states of the step before as given by c_all ``[T, 2B, H]`` and
    h_all ``[T, 2B, P]`` (zeros before the first).  Returns (out, c_all,
    h_all) as those steps give them.

    Held against a kernel's own per-step states, this checks each step
    alone: a rounding difference is not carried on through the sequence."""
    time_steps, b2, _ = gx.shape
    gx4, keep4, valid4 = _step_views(gx, sequence_length, keep)

    def before(s):
        s = torch.cat([torch.zeros_like(s[:1]), s[:-1]])
        return s.view(time_steps, 2, b2 // 2, s.shape[-1])

    out, c, h = _dual_step(gx4, keep4, valid4, before(c_all), before(h_all),
                           wh, proj, peep, forget_bias)
    return (out.reshape(time_steps, b2, -1), c.reshape(time_steps, b2, -1),
            h.reshape(time_steps, b2, -1))


def _bwd_step(gx_t, keep_t, valid_t, c_prev, h_prev, dout_t, dc, dh, wh,
              proj, peep, forget_bias: float):
    """The backward of one step of both directions (``lstm_pallas.
    _make_bwd_kernel`` :230-319), on leading dims ``[..., 2, B]``: the
    gates are recomputed from the stored previous states (already zeroed
    at segment starts), then (dc, dh), the cotangents of the carried
    states after the step, are carried back through it.  Returns (dgates,
    dc_prev, dh_prev, c_new, out_blk, dout_p)."""
    num_units = c_prev.shape[-1]
    cdt = wh.dtype
    m = valid_t
    gates = gx_t + matmul_f32(h_prev, wh, cdt)
    i, j, f, o = gates.split(num_units, dim=-1)
    if peep is not None:
        i = i + peep[:, 0, None, :] * c_prev
        f = f + peep[:, 1, None, :] * c_prev
    si, tj = torch.sigmoid(i), torch.tanh(j)
    sf = torch.sigmoid(f + forget_bias)
    c_new = sf * c_prev + si * tj
    if peep is not None:
        o = o + peep[:, 2, None, :] * c_new
    so, tc = torch.sigmoid(o), torch.tanh(c_new)
    out_blk = so * tc
    # h_next = m·out_p + (1-m)·h_prev, and the emitted out is m·out_p
    dout_p = m * (dout_t + dh)
    dout_blk = dout_p if proj is None else matmul_f32(
        dout_p, proj.transpose(-1, -2), cdt)
    do = dout_blk * tc * so * (1.0 - so)
    # c_next = m·c_new + (1-m)·c_prev
    dc_new = dout_blk * so * (1.0 - tc * tc) + m * dc
    if peep is not None:
        dc_new = dc_new + do * peep[:, 2, None, :]
    df = dc_new * c_prev * sf * (1.0 - sf)
    di = dc_new * tj * si * (1.0 - si)
    dj = dc_new * si * (1.0 - tj * tj)
    dc_prev = dc_new * sf + (1.0 - m) * dc
    if peep is not None:
        dc_prev = dc_prev + df * peep[:, 1, None, :] + di * peep[:, 0, None, :]
    dgates = torch.cat([di, dj, df, do], dim=-1)
    dh_prev = (1.0 - m) * dh + matmul_f32(dgates, wh.transpose(-1, -2), cdt)
    if keep_t is not None:
        dc_prev = keep_t * dc_prev
        dh_prev = keep_t * dh_prev
    return dgates, dc_prev, dh_prev, c_new, out_blk, dout_p


def _previous(states, keep4):
    """Per-step states ``[T, 2B, X]`` → the states each step starts from,
    ``[T, 2, B, X]`` float32: shifted by one step (zeros first) and zeroed
    where a packed segment starts."""
    time_steps, b2, width = states.shape
    prev = torch.cat([torch.zeros_like(states[:1]), states[:-1]]).float()
    prev = prev.view(time_steps, 2, b2 // 2, width)
    return prev if keep4 is None else prev * keep4


def _weight_grads(dgates, h_prev, c_prev, c_new, out_blk, dout_p, cdt):
    """The layer backward's weight gradients over its per-step tensors
    ``[T, 2, B, X]`` (dgates as stored, h_prev and c_prev kept): dwh =
    Σ h_prevᵀ·dgates, dproj = Σ out_blkᵀ·dout_p (None when out_blk is) with
    operands rounded to ``cdt`` and float32 sums, and the peephole sums
    (None when c_new is) from dgates as stored."""
    time_steps, _, batch, h4 = dgates.shape
    num_units = h4 // 4

    def rows_of(x):                          # [T, 2, B, X] -> [2, T·B, X]
        return x.transpose(0, 1).reshape(2, time_steps * batch, x.shape[-1])

    dwh = matmul_f32(rows_of(h_prev).transpose(1, 2), rows_of(dgates), cdt)
    dproj = None
    if out_blk is not None:
        dproj = matmul_f32(rows_of(out_blk).transpose(1, 2), rows_of(dout_p),
                           cdt)
    dpeep = None
    if c_new is not None:
        dg32 = dgates.float()
        dpeep = torch.stack([
            (dg32[..., :num_units] * c_prev).sum((0, 2)),
            (dg32[..., 2 * num_units:3 * num_units] * c_prev).sum((0, 2)),
            (dg32[..., 3 * num_units:] * c_new).sum((0, 2))], dim=1)
    return dwh, dproj, dpeep


def dual_recurrence_backward(gx, sequence_length, keep, wh, proj, peep,
                             forget_bias: float, c_all, h_all, dout, dcfin,
                             dhfin, store_dtype=torch.float32,
                             steps: bool = False):
    """Plain version of the BLSTM layer backward kernel (``csrc/
    lstm_bwd.cu``, replacing ``lstm_pallas._make_bwd_kernel``).

    gx, sequence_length, keep, wh, proj, peep as ``dual_recurrence``;
    c_all ``[T, 2B, H]`` and h_all ``[T, 2B, P]`` the forward's per-step
    states (in the store dtype); dout ``[T, 2B, P]``, dcfin ``[2B, H]``,
    dhfin ``[2B, P]`` the cotangents of the layer's outputs.  Returns
    (dgates ``[T, 2B, 4H]`` in ``store_dtype``, dwh ``[2, P, 4H]``, dproj
    ``[2, H, P]`` or None, dpeep ``[2, 3, H]`` or None), float32.  With
    ``steps``, also the cotangents of the carried states entering each
    step, dc_in ``[T, 2B, H]`` and dh_in ``[T, 2B, P]`` (the last step's
    are dcfin, dhfin).

    Weight gradients are summed over (t, b) after the loop, with operands
    rounded to the compute dtype, as the reference kernel accumulates
    them per time block: dwh = Σ h_prevᵀ·dgates, dproj = Σ out_blkᵀ·dout_p,
    and the peephole sums from dgates as stored."""
    time_steps, b2, h4 = gx.shape
    batch, num_units = b2 // 2, h4 // 4
    out_dim = h_all.shape[2]
    cdt = wh.dtype
    gx4, keep4, valid4 = _step_views(gx, sequence_length, keep)
    c_prev = _previous(c_all, keep4)
    h_prev = _previous(h_all, keep4)
    dout4 = dout.float().reshape(time_steps, 2, batch, out_dim)
    dc = dcfin.float().reshape(2, batch, num_units)
    dh = dhfin.float().reshape(2, batch, out_dim)
    dgs, c_news, out_blks, dout_ps, dc_in, dh_in = [], [], [], [], [], []
    for t in range(time_steps - 1, -1, -1):
        if steps:
            dc_in.append(dc)
            dh_in.append(dh)
        dg, dc, dh, c_new, out_blk, dout_p = _bwd_step(
            gx4[t], None if keep4 is None else keep4[t], valid4[t],
            c_prev[t], h_prev[t], dout4[t], dc, dh, wh, proj, peep,
            forget_bias)
        dgs.append(dg.to(store_dtype))
        c_news.append(c_new)
        out_blks.append(out_blk)
        dout_ps.append(dout_p)

    def stacked(rows):                       # forward time order
        return torch.stack(rows[::-1])       # [T, 2, B, X]

    dgates = stacked(dgs)
    dwh, dproj, dpeep = _weight_grads(
        dgates, h_prev, c_prev, None if peep is None else stacked(c_news),
        None if proj is None else stacked(out_blks), stacked(dout_ps), cdt)
    result = (dgates.reshape(time_steps, b2, h4), dwh, dproj, dpeep)
    if steps:
        result += (stacked(dc_in).reshape(time_steps, b2, num_units),
                   stacked(dh_in).reshape(time_steps, b2, out_dim))
    return result


def fold_input_side(x2, wx, dgates, store_dtype=torch.float32):
    """The input side of a BLSTM layer over its dgates, as the folded
    backward kernel (``csrc/lstm_bwd_fold.cu``, replacing ``lstm_pallas.
    _make_bwd_kernel(fold_dx=True)`` :373-399) computes it.

    x2 ``[2, B, T, D]`` the layer input and its reverse, wx ``[2, D, 4H]``
    in the compute dtype, dgates ``[T, 2B, 4H]`` as stored.  Returns (dx2
    ``[2, B, T, D]`` in ``store_dtype``, dwx ``[2, D, 4H]``, dbias
    ``[2, 4H]``): dwx = x(cdt)ᵀ·dg(cdt) and dx = dg(cdt)·wx(cdt)ᵀ with
    float32 sums, dbias = Σ dg in float32."""
    _, batch, time_steps, dim = x2.shape
    h4 = dgates.shape[2]
    cdt = wx.dtype
    dg = dgates.view(time_steps, 2, batch, h4).permute(1, 2, 0, 3).reshape(
        2, batch * time_steps, h4)
    dwx = matmul_f32(x2.reshape(2, batch * time_steps, dim).transpose(1, 2),
                     dg, cdt)
    dx2 = matmul_f32(dg, wx.transpose(1, 2), cdt).to(store_dtype)
    return (dx2.view(2, batch, time_steps, dim), dwx,
            dg.float().sum(1))


def dual_recurrence_backward_fold(x2, wx, gx, sequence_length, keep, wh,
                                  proj, peep, forget_bias: float, c_all,
                                  h_all, dout, dcfin, dhfin,
                                  store_dtype=torch.float32,
                                  steps: bool = False):
    """Plain version of the folded BLSTM layer backward kernel (``csrc/
    lstm_bwd_fold.cu``): ``dual_recurrence_backward``, then
    ``fold_input_side`` over its dgates.

    x2 and wx as ``fold_input_side``; the rest as
    ``dual_recurrence_backward``.  Returns (dx2, dwx, dbias, dwh, dproj,
    dpeep) and, with ``steps``, also (dgates, dc_in, dh_in)."""
    out = dual_recurrence_backward(gx, sequence_length, keep, wh, proj, peep,
                                   forget_bias, c_all, h_all, dout, dcfin,
                                   dhfin, store_dtype, steps)
    result = fold_input_side(x2, wx, out[0], store_dtype) + out[1:4]
    return result + ((out[0],) + out[4:] if steps else ())


def replay_backward_steps(gx, sequence_length, keep, wh, proj, peep,
                          forget_bias: float, c_all, h_all, dout, dc_in,
                          dh_in, store_dtype=torch.float32, dgates=None):
    """Every step of the plain backward at once, each started from the
    carried cotangents entering it as given by dc_in ``[T, 2B, H]`` and
    dh_in ``[T, 2B, P]``.  Returns (dgates in ``store_dtype``, dc_out,
    dh_out): dc_out[t] and dh_out[t] are what step t carries on to step
    t-1, to be held against dc_in[t-1] and dh_in[t-1].  With ``dgates`` (a
    kernel's own ``[T, 2B, 4H]``, as stored), also (dwh, dproj, dpeep)
    summed as ``dual_recurrence_backward`` sums them, over those dgates and
    the steps' c_new, out_blk and dout_p.

    Held against a kernel's own per-step carries, this checks each step
    alone: a rounding difference is not carried on through the sequence;
    and held against its weight gradients, their products alone."""
    time_steps, b2, h4 = gx.shape
    gx4, keep4, valid4 = _step_views(gx, sequence_length, keep)

    def view(x):
        return x.float().reshape(time_steps, 2, b2 // 2, x.shape[-1])

    c_prev, h_prev = _previous(c_all, keep4), _previous(h_all, keep4)
    dg, dc, dh, c_new, out_blk, dout_p = _bwd_step(
        gx4, keep4, valid4, c_prev, h_prev, view(dout), view(dc_in),
        view(dh_in), wh, proj, peep, forget_bias)
    result = (dg.reshape(time_steps, b2, h4).to(store_dtype),
              dc.reshape(time_steps, b2, -1), dh.reshape(time_steps, b2, -1))
    if dgates is None:
        return result
    return result + (_weight_grads(
        dgates.reshape(time_steps, 2, b2 // 2, h4), h_prev, c_prev,
        None if peep is None else c_new, None if proj is None else out_blk,
        dout_p, wh.dtype),)


def lstm_scan(params: Dict, x: torch.Tensor, sequence_length: torch.Tensor,
              forget_bias: float = 1.0, initial_state=None,
              compute_dtype=None):
    """One unidirectional LSTM layer, in plain PyTorch (``cells.lstm_scan``
    of the reference, :62-129, without ``reverse``): x ``[B, T, D]`` →
    (outputs ``[B, T, P]``, zero past each length; final (c ``[B, H]``,
    h ``[B, P]``)).  ``initial_state`` is an optional (c, h); matmul
    operands are rounded to ``compute_dtype`` (x's dtype if None), sums and
    the carried state stay float32.  Differentiable by autograd; the
    oracle the stack and layer kernels are held to."""
    batch, time_steps, _ = x.shape
    num_units = params["bias"].shape[0] // 4
    out_dim = params["proj"].shape[1] if "proj" in params else num_units
    cdt = compute_dtype or x.dtype
    peep = "w_i_diag" in params
    gx = matmul_f32(x, params["wx"], cdt) + params["bias"]
    valid, _ = step_masks(sequence_length, None, time_steps, x.device)
    if initial_state is None:
        c = x.new_zeros(batch, num_units, dtype=torch.float32)
        h = x.new_zeros(batch, out_dim, dtype=torch.float32)
    else:
        c, h = (s.float() for s in initial_state)
    outs = []
    for t in range(time_steps):
        gates = gx[:, t] + matmul_f32(h, params["wh"], cdt)
        i, j, f, o = gates.split(num_units, dim=-1)
        if peep:
            i = i + params["w_i_diag"] * c
            f = f + params["w_f_diag"] * c
        c_new = (torch.sigmoid(f + forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(j))
        if peep:
            o = o + params["w_o_diag"] * c_new
        out = torch.sigmoid(o) * torch.tanh(c_new)
        if "proj" in params:
            out = matmul_f32(out, params["proj"], cdt)
        m = valid[t][:, None]
        c = m * c_new + (1.0 - m) * c
        h = m * out + (1.0 - m) * h
        outs.append(m * out)
    return torch.stack(outs, dim=1), (c, h)


class DropoutStreams:
    """The two random streams of a training step, on one device: ``masks``
    draws the dropout masks, ``seeds`` the hash-dropout seeds of the fused
    kernels, and ``seed_offset`` is added to each seed drawn.  Under data
    parallelism every rank draws its own masks (the reference's masks are
    slices of one global mask) and the same seeds, offset by 7919·rank as
    the reference's shard offsets them (``parallel/mesh.py``).  A plain
    ``torch.Generator`` in their place draws both, with no offset."""

    def __init__(self, masks: torch.Generator, seeds: torch.Generator,
                 seed_offset: int = 0):
        self.masks, self.seeds, self.seed_offset = masks, seeds, seed_offset

    @classmethod
    def for_rank(cls, device, seed: int, rank: int = 0) -> "DropoutStreams":
        """Rank ``rank``'s streams of a run seeded with ``seed``: its own
        masks, the seeds every rank draws, offset by 7919·rank
        (``parallel.SEED_STRIDE``)."""
        from ..parallel.mesh import SEED_STRIDE
        masks = torch.Generator(device).manual_seed(seed + ((rank + 1) << 32))
        seeds = torch.Generator(device).manual_seed(seed)
        return cls(masks, seeds, SEED_STRIDE * rank)

    def whole(self) -> "DropoutStreams":
        """The streams of a batch every rank computes whole: the masks drawn
        from the shared stream and no offset, so the ranks agree."""
        return DropoutStreams(self.seeds, self.seeds, 0)


def mask_generator(generator):
    """The generator that draws dropout masks."""
    return generator.masks if isinstance(generator, DropoutStreams) \
        else generator


def draw_seed(generator, device) -> torch.Tensor:
    """A hash-dropout seed as a one-element int32 tensor on ``device``,
    drawn as the reference draws it (``jax.random.randint(k, (1,),
    -2**31, 2**31 - 1)``), plus the streams' offset (int32, wrapping)."""
    offset = 0
    if isinstance(generator, DropoutStreams):
        generator, offset = generator.seeds, generator.seed_offset
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)
    if offset:
        seed = (seed.long() + offset).remainder(2 ** 32)
        seed = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed).int()
    return seed


def dropout(generator, x: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """Inverted dropout with *keep* probability (``cells.dropout`` of the
    reference; the reference's ``dropout_rate = 0.9`` means keep 0.9).
    The mask is drawn from ``generator`` (a ``torch.Generator`` or the
    masks of ``DropoutStreams``), which lies on x's device; its stream
    differs from ``jax.random``'s."""
    if keep_prob >= 1.0:
        return x
    u = torch.rand(x.shape, generator=mask_generator(generator),
                   device=x.device)
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def split_directions(out, cfin, hfin, batch: int):
    """Kernel layout → the scan's return value: (fw_out [B,T,P], bw_out
    [B,T,P] (still reversed), ((c_fw, h_fw), (c_bw, h_bw)))."""
    fw_out = out[:, :batch].transpose(0, 1)
    bw_out = out[:, batch:].transpose(0, 1)
    return fw_out, bw_out, ((cfin[:batch], hfin[:batch]),
                            (cfin[batch:], hfin[batch:]))


def bilstm_dual_scan(fw_params: Dict,
                     bw_params: Dict,
                     x: torch.Tensor,
                     x_rev: torch.Tensor,
                     sequence_length: torch.Tensor,
                     forget_bias: float = 1.0,
                     compute_dtype=None,
                     reset_mask=None):
    """Forward and backward cells of one BLSTM layer, in plain PyTorch.

    x is the layer input, x_rev its ``reverse_sequence``; both use the same
    time mask.  Returns (fw_out [B,T,P], bw_out [B,T,P] (still reversed),
    (fw_state, bw_state)) like the reference's ``bilstm_dual_scan``."""
    gx, wh, proj, peep = layer_inputs(fw_params, bw_params, x, x_rev,
                                      compute_dtype)
    _, keep = step_masks(sequence_length, reset_mask, x.shape[1], x.device)
    out, cfin, hfin = dual_recurrence(gx, sequence_length, keep, wh, proj,
                                      peep, forget_bias)
    return split_directions(out, cfin, hfin, x.shape[0])


def _take_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def reverse_sequence(x: torch.Tensor,
                     sequence_length: torch.Tensor) -> torch.Tensor:
    """Reverse the first ``sequence_length`` steps of each row, leaving
    padding in place (``tf.reverse_sequence``)."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    lengths = sequence_length.to(x.device).long()[:, None]
    return _take_time(x, torch.where(t < lengths, lengths - 1 - t, t))


def reverse_segments(x: torch.Tensor,
                     sequence_length: torch.Tensor,
                     reset_mask: torch.Tensor) -> torch.Tensor:
    """Segment-wise ``reverse_sequence`` for packed rows: each segment
    (delimited by ``reset_mask`` starts) is reversed in place; padding
    past ``sequence_length`` stays put."""
    batch, time_steps = x.shape[0], x.shape[1]
    t = torch.arange(time_steps, device=x.device)[None, :].expand(batch, -1)
    r = reset_mask.to(x.device) > 0.5
    start = torch.cummax(torch.where(r, t, torch.zeros_like(t)), dim=1)[0]
    nxt = torch.where(r, t, torch.full_like(t, time_steps))
    nxt_after = torch.cat(
        [nxt[:, 1:], torch.full_like(nxt[:, :1], time_steps)], dim=1)
    nxt_after = torch.cummin(nxt_after.flip(1), dim=1)[0].flip(1)
    lengths = sequence_length.to(x.device).long()[:, None]
    end = torch.minimum(nxt_after, lengths)
    idx = torch.where(t < lengths, start + end - 1 - t, t)
    return _take_time(x, idx.clamp(0, time_steps - 1))
