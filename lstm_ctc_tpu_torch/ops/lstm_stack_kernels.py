"""A whole unidirectional LSTM stack in one kernel: the wrappers around
``csrc/lstm_stack_fwd.cu`` (K12) and ``csrc/lstm_stack_bwd.cu`` (K13), their
plain PyTorch versions, and the packing of the stack's weights.

Counterpart of ``lstm_ctc_tpu/ops/lstm_stack_pallas.py``: ``stack_eligible``
(:586-612), ``lstm_stack_fused`` (:615-750) and its VJP ``fused`` /
``fused_bwd`` (:530-582), whose Pallas kernels ``_make_fwd_kernel`` (:64)
and ``_make_bwd_kernel`` (:184) run the stack as a diagonal wavefront: at
step s layer l runs time t = s - l, for S = T + L - 1 steps, and every
per-step stream is laid out by s with the layers stacked on the row axis
([S, L·B, ·]).  The kernels here keep that layout, its masks and its hash
dropout (drawn at row s·L·B + l·B + b, column p), so they compute the same
function, ordering the work for the card: both run one cluster per (layer,
tile of batch rows), of 8 blocks where the 8-block plan fits (up to 64
units a block) and of 16 where only that fits (up to 128 a block, so up to
2048 units), with the layer's recurrent weights in its shared memory (bf16;
float32 reads them from L2), the layers pipelined in chunks of K steps
(the lag), each layer's input products off its recurrence
(``csrc/lstm_stack_fwd.cu``, ``csrc/lstm_stack_bwd.cu``; ``stack_config``
says how they launch).  A bf16 stack whose slices fit no resident plan
(H = P = 1024 without a projection, 2048 cells with a projection of 512)
takes the streamed plan: 16 blocks that keep wh's first rows in shared
memory and stream the rest, and proj, from L2 at every step, as K1 and K2
do.  A row tile's L clusters run together, so a stack deeper than the
clusters the card holds at once has no launch: the route
(``stack_eligible``) runs it layer by layer, as it does a stack past 2048
units.

Layer 0's input projection gx0 = x·wx0 + b0 is one GEMM outside the
kernels, and in training its gradients are autograd's products over the
dgates rows of layer 0 that K13 emits, as XLA's are outside the TPU kernel.
The packed weights: wz ``[L, 2P, 4H]`` (wz[l] = [wx_l; wh_l], layer 0's
input slab zero) and proj ``[L, H, P]`` in the compute dtype; bias
``[L, 4H]`` (layer 0's zero, it is in gx0), peep ``[L, 3, H]`` (the i, f, o
diagonals) in float32, whatever the plan.  The kernels take them cut per
cluster block for the blocks of the plan that launches (``stack_slices``):
wh and proj as K1's slices, wx as rows of the block's gate columns
(``_input_rows``), proj also as K2's rows for K13; on the streamed plan
each row of wh (and of K13's proj rows) padded as it lies in shared
memory, as K1's and K2's.

On a CPU tensor a wrapper runs its plain version (``stack_forward_reference``,
``stack_backward_reference``); on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from ..models import cells
from .lstm_kernels import (LAYER_BLOCK_UNITS, PLANS, _expect, _proj_rows,
                           _ptr, _round_up, _slices)
from .moe_kernels import _seed_ptr, hash_uniform
from .route import warn_once

_DIAG = ("w_i_diag", "w_f_diag", "w_o_diag")
# hidden units of a stack, at most: its clusters have at most 16 blocks of
# at most 128 units, as the layer kernels'
MAX_UNITS = 16 * LAYER_BLOCK_UNITS


@functools.lru_cache(maxsize=None)
def _unplanned(units: int, out_dim: int, has_proj: bool, bf16: bool,
               store_bf16: bool, train: bool):
    """Which of K12 and, with ``train``, K13 has no launch plan for this
    shape, or None: the plans' own arithmetic in the library (each answers
    the blocks a cluster of its plan, negative for the streamed plan, 0
    for none), no CUDA call, asked once
    a shape (the plans do not depend on the batch, the steps or the layers
    but through the clusters the card holds at once: ``_unheld``)."""
    lib = _build.library()
    if not lib.lstm_stack_fwd_fits(units, out_dim, int(has_proj), int(bf16)):
        return "forward (K12)"
    if train and not lib.lstm_stack_bwd_fits(units, out_dim, int(has_proj),
                                             int(bf16), int(store_bf16)):
        return "backward (K13)"
    return None


def _unheld(device, layers: int, units: int, out_dim: int, has_proj: bool,
            bf16: bool, store_bf16: bool, train: bool):
    """(kernel, clusters resident at once) of K12 or, with ``train``, K13
    when the card cannot hold a row tile's ``layers`` clusters together,
    or None: the launchers' own choice (``stack_config`` at one row and one
    step: residency does not depend on the batch or the steps), cached a
    shape and depth."""
    index = torch.device(device).index or 0
    kernels = (("forward (K12)", False), ("backward (K13)", True))
    for what, backward in kernels[:1 + int(train)]:
        how = dict(_config(index, 1, layers, 1, units, out_dim, has_proj, bf16,
                           backward, store_bf16))
        if not how["rows"]:
            return what, how["resident"]
    return None


def _plan_refusal(device, units: int, out_dim: int, has_proj: bool, dtype,
                  train: bool, store_dtype, warn: bool, layers: int = 1) -> bool:
    """Whether, on a CUDA ``device``, K12 (or in training K13) has no
    launch plan for this shape, or (``layers`` > 1) the card cannot hold a
    row tile's layers at once; with ``warn``, warn once per reason."""
    if device is None or torch.device(device).type != "cuda":
        return False
    bf16, store_bf16 = dtype == torch.bfloat16, store_dtype == torch.bfloat16
    name = str(dtype).split(".")[-1]
    what = _unplanned(units, out_dim, has_proj, bf16, store_bf16, train)
    if what is not None:
        if warn:
            warn_once("lstm stack %s plan" % what, "lstm: the CUDA stack %s "
                      "has no launch plan for a %s stack of H=%d P=%d (its "
                      "threads or shared memory exceed a block's); running "
                      "it layer by layer." % (what, name, units, out_dim))
        return True
    unheld = None if layers < 2 else _unheld(
        device, layers, units, out_dim, has_proj, bf16, store_bf16, train)
    if unheld is None:
        return False
    if warn:
        warn_once("lstm stack resident", "lstm: the card holds %d clusters "
                  "of the CUDA stack %s at once for a %s stack of H=%d P=%d, "
                  "fewer than its %d layers (a row tile's layers run "
                  "together); running it layer by layer."
                  % (unheld[1], unheld[0], name, units, out_dim, layers))
    return True


def stack_uniform(params_list: Sequence[Dict]) -> bool:
    """Whether a stack has the stack kernels' structure, as
    ``lstm_stack_pallas.stack_eligible`` asks it: at least two layers, the
    same units, projection and peephole structure on every layer, every
    layer past the first fed P-wide, and no residual on layer 0 (an input
    as wide as the output would need the raw input inside the kernel)."""
    p0 = params_list[0]
    units = p0["bias"].shape[0] // 4
    out_dim = p0["proj"].shape[1] if "proj" in p0 else units
    if len(params_list) < 2 or p0["wx"].shape[0] == out_dim:
        return False
    for p in params_list[1:]:
        if (p["wx"].shape[0] != out_dim or p["bias"].shape != p0["bias"].shape
                or ("proj" in p) != ("proj" in p0)
                or ("w_i_diag" in p) != ("w_i_diag" in p0)):
            return False
        if "proj" in p0 and p["proj"].shape != p0["proj"].shape:
            return False
    return True


def stack_eligible(params_list: Sequence[Dict], train: bool = False,
                   warn: bool = False, device=None, dtype=torch.float32,
                   store_dtype=torch.float32) -> bool:
    """The stack kernels apply when the stack is uniform
    (``stack_uniform``) and the kernels take its shape: at most 2048 units
    (16 blocks of 128), with ``train`` (K13) H and P divisible by 4, and on
    a CUDA ``device`` a launch plan of K12 (and K13) in the compute
    ``dtype`` (K13's states in ``store_dtype``) that fits a block, as
    ``lstm_kernels.layer_eligible`` asks K1's, and whose L clusters of a
    row tile the card holds at once.  With ``warn``, a refusal of the
    shape warns once per process for each reason."""
    p0 = params_list[0]
    units = p0["bias"].shape[0] // 4
    out_dim = p0["proj"].shape[1] if "proj" in p0 else units
    if units > MAX_UNITS:
        if warn:
            warn_once("lstm stack units", "lstm: a stack of %d units exceeds "
                      "the CUDA stack kernels' %d; running it layer by "
                      "layer." % (units, MAX_UNITS))
        return False
    if not stack_uniform(params_list):
        return False
    if train and (units % 4 or out_dim % 4):
        if warn:
            warn_once("lstm stack backward width", "lstm: the CUDA stack "
                      "backward takes H and P divisible by 4, got H=%d P=%d; "
                      "running the stack layer by layer." % (units, out_dim))
        return False
    return not _plan_refusal(device, units, out_dim, "proj" in p0, dtype,
                             train, store_dtype, warn, len(params_list))


def stack_layer_eligible(cell: Dict, device, dtype, warn: bool = False) -> bool:
    """Whether K12 runs this one layer forward with carried states (the
    streaming path of a stack the stack route refused): at most 2048 units
    and, on a CUDA ``device``, a launch plan of K12 in ``dtype``, resident
    or streamed."""
    units = cell["bias"].shape[0] // 4
    out_dim = cell["proj"].shape[1] if "proj" in cell else units
    return units <= MAX_UNITS and not _plan_refusal(
        device, units, out_dim, "proj" in cell, dtype, False, torch.float32,
        warn)


def stack_weights(params_list: Sequence[Dict], compute_dtype):
    """``(wz, bias, proj, peep)`` of a uniform stack, as the module
    docstring lays them out.  Made once per model and dtype
    (``cells.derived``) unless the weights are being differentiated."""
    p0 = params_list[0]

    def build():
        wz = torch.stack([
            torch.cat([torch.zeros_like(p["wh"]) if l == 0 else p["wx"],
                       p["wh"]]) for l, p in enumerate(params_list)])
        bias = torch.stack([torch.zeros_like(p["bias"]) if l == 0
                            else p["bias"]
                            for l, p in enumerate(params_list)]).float()
        proj = peep = None
        if "proj" in p0:
            proj = torch.stack([p["proj"] for p in params_list]).to(
                compute_dtype).contiguous()
        if "w_i_diag" in p0:
            peep = torch.stack([torch.stack([p[n] for n in _DIAG])
                                for p in params_list]).float().contiguous()
        return wz.to(compute_dtype).contiguous(), bias.contiguous(), proj, peep

    sources = [p[n] for p in params_list
               for n in ("wx", "wh", "bias", "proj") + _DIAG if n in p]
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return build()
    return cells.derived(sources, ("stack", compute_dtype), build)


def stack_mask(sequence_length, time_steps: int, num_layers: int, device):
    """``[S, L·B]`` float32: 1 where layer l is live at wavefront step s,
    0 <= s - l < T and s - l < length[b]."""
    steps = time_steps + num_layers - 1
    s = torch.arange(steps, device=device)[:, None, None]
    t = s - torch.arange(num_layers, device=device)[None, :, None]
    lengths = sequence_length.to(device).long()[None, None, :]
    valid = (t >= 0) & (t < time_steps) & (t < lengths)
    return valid.float().reshape(steps, -1).contiguous()


def _drop_mask(seed, keep_prob: float, steps: int, layers: int, batch: int,
               out_dim: int, device):
    """The stack's dropout factors ``[S, L, B, P]`` (None at keep 1): the
    hash at row s·L·B + l·B + b, column p, 1/keep where kept."""
    if keep_prob >= 1.0:
        return None
    u = hash_uniform(seed, 0, 0, steps * layers * batch, out_dim, device)
    keep = (u < keep_prob).float() * (1.0 / keep_prob)
    return keep.view(steps, layers, batch, out_dim)


def layer_drop_factors(seed, keep_prob: float, time_steps: int, layers: int,
                       batch: int, out_dim: int, device):
    """The stack's dropout factors as each layer's outputs meet them,
    ``[L, B, T, P]``: layer l's step t is wavefront step s = t + l (None at
    keep 1).  A uniform stack run layer by layer applies these, so it
    computes what K12 computes."""
    drop = _drop_mask(seed, keep_prob, time_steps + layers - 1, layers, batch,
                      out_dim, device)
    if drop is None:
        return None
    return torch.stack([drop[l:l + time_steps, l] for l in range(layers)]
                       ).transpose(1, 2)


def _dims(gx0, wz):
    steps, batch, h4 = gx0.shape
    return steps, wz.shape[0], batch, h4 // 4, wz.shape[1] // 2


def _with_gx0(gates, gx0_s):
    """Add layer 0's input projection to its gate rows: gates
    ``[..., L, B, 4H]``, gx0_s ``[..., B, 4H]``."""
    return torch.cat([gates[..., :1, :, :] + gx0_s.unsqueeze(-3),
                      gates[..., 1:, :, :]], dim=-3)


def _layer_matmul(x, w, cdt):
    """``cells.matmul_f32`` of x ``[..., L, B, K]`` by each layer's w
    ``[L, K, N]``, as one product a layer: matmul would broadcast w over
    the leading dims (a replay's steps) and copy it once each."""
    if x.dim() == 3:
        return cells.matmul_f32(x, w, cdt)
    layers, batch, depth = x.shape[-3:]
    rows = x.movedim(-3, 0).reshape(layers, -1, depth)
    y = cells.matmul_f32(rows, w, cdt)
    return y.reshape((layers,) + x.shape[:-3] + (batch, -1)).movedim(0, -3)


def _forward_step(gx0_s, m, inb, c, h, wz, bias, proj, peep, rvec,
                  forget_bias: float, drop_s, affine):
    """One wavefront step of every layer (``_make_fwd_kernel`` :96-167), on
    leading dims ``[..., L, B]``: m ``[..., L, B, 1]``; inb the layers'
    inputs (layer l-1's chain of the step before), c, h the carried states.
    Returns (c_next, h_next, chain)."""
    num_units = c.shape[-1]
    cdt = wz.dtype
    z = torch.cat([inb, h], dim=-1)
    gates = _with_gx0(_layer_matmul(z, wz, cdt) + bias[:, None, :], gx0_s)
    i, j, f, o = gates.split(num_units, dim=-1)
    if peep is not None:
        i = i + peep[:, 0, None, :] * c
        f = f + peep[:, 1, None, :] * c
    c_new = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
    if peep is not None:
        o = o + peep[:, 2, None, :] * c_new
    out = torch.sigmoid(o) * torch.tanh(c_new)
    if proj is not None:
        out = _layer_matmul(out, proj, cdt)
    chain = m * out + rvec * inb
    if drop_s is not None:
        chain = chain * drop_s
    if affine is not None:
        chain = chain * affine[0][:, None, :] + affine[1][:, None, :]
    return m * c_new + (1.0 - m) * c, m * out + (1.0 - m) * h, chain


def _residual_vector(residual, layers: int, device):
    return torch.tensor([float(r) for r in residual], device=device).view(
        layers, 1, 1)


def stack_forward_reference(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                            residual, forget_bias: float, keep_prob=1.0,
                            seed=None, affine=None,
                            store_dtype=torch.float32):
    """Plain version of K12, step by step over the wavefront.

    gx0 ``[S, B, 4H]`` float32 (zero past T); mask ``[S, L·B]``
    (``stack_mask``); wz, bias, proj, peep as ``stack_weights``; cinit
    ``[L·B, H]``, hinit ``[L·B, P]``; residual L flags; seed an int32
    tensor of one element (read only at keep < 1); affine (a, b), each
    ``[L, P]``, or None.  Returns out ``[S, B, P]`` (the last layer's
    chain), chain ``[S, L·B, P]``, c_all ``[S, L·B, H]``, h_all
    ``[S, L·B, P]`` (the carried states after each step) in ``store_dtype``,
    and the final states cfin ``[L·B, H]``, hfin ``[L·B, P]``, float32."""
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    m_all = mask.view(steps, layers, batch, 1).float()
    rvec = _residual_vector(residual, layers, gx0.device)
    drop = _drop_mask(seed, keep_prob, steps, layers, batch, out_dim,
                      gx0.device)
    c = cinit.view(layers, batch, units).float()
    h = hinit.view(layers, batch, out_dim).float()
    inb = gx0.new_zeros(layers, batch, out_dim)
    chains, cs, hs = [], [], []
    for s in range(steps):
        c, h, chain = _forward_step(
            gx0[s], m_all[s], inb, c, h, wz, bias, proj, peep, rvec,
            forget_bias, None if drop is None else drop[s], affine)
        chains.append(chain)
        cs.append(c)
        hs.append(h)
        inb = torch.cat([torch.zeros_like(chain[:1]), chain[:-1]])
    chain = torch.stack(chains)
    lb = layers * batch
    return (chain[:, -1].contiguous(),
            chain.reshape(steps, lb, out_dim).to(store_dtype),
            torch.stack(cs).reshape(steps, lb, units).to(store_dtype),
            torch.stack(hs).reshape(steps, lb, out_dim).to(store_dtype),
            c.reshape(lb, units), h.reshape(lb, out_dim))


def _previous(states, init, layers: int):
    """Per-step states ``[S, L·B, X]`` → the states each step starts from,
    ``[S, L, B, X]`` float32: the init (rounded to the store dtype) first."""
    steps, lb, width = states.shape
    prev = torch.cat([init.to(states.dtype)[None], states[:-1]]).float()
    return prev.view(steps, layers, lb // layers, width)


def _inputs_before(chain, layers: int):
    """in_prev ``[S, L, B, P]``: layer l-1's stored chain at s-1 (zero for
    layer 0 and at s = 0)."""
    steps, lb, width = chain.shape
    c = chain.float().view(steps, layers, lb // layers, width)
    shifted = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)
    return torch.cat([torch.zeros_like(shifted[:1]), shifted[:-1]])


def stack_replay_steps(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                       residual, forget_bias: float, keep_prob, seed, affine,
                       chain, c_all, h_all):
    """Every step of the plain forward at once, each started from a
    kernel's own states of the step before (chain, c_all, h_all as K12
    stores them).  Returns (chain, c_all, h_all) as those steps give them,
    ``[S, L·B, ·]`` float32.  Held against the kernel's own streams, this
    checks each step alone: a rounding difference is not carried on."""
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    drop = _drop_mask(seed, keep_prob, steps, layers, batch, out_dim,
                      gx0.device)
    c, h, ch = _forward_step(
        gx0, mask.view(steps, layers, batch, 1).float(),
        _inputs_before(chain, layers), _previous(c_all, cinit, layers),
        _previous(h_all, hinit, layers), wz, bias, proj, peep,
        _residual_vector(residual, layers, gx0.device), forget_bias, drop,
        affine)
    lb = layers * batch
    return (ch.reshape(steps, lb, -1), c.reshape(steps, lb, -1),
            h.reshape(steps, lb, -1))


def _backward_step(gx0_s, m, z, c_prev, dchain, dc, dh, wz, bias, proj, peep,
                   rvec, forget_bias: float):
    """The backward of one wavefront step of every layer (``_make_bwd_
    kernel`` :218-326), on leading dims ``[..., L, B]``: the gates are
    recomputed from z = [in_prev, h_prev] and c_prev; dchain is the
    cotangent of the layers' (pre-dropout) chain, (dc, dh) those of the
    carried states after the step.  Returns (dgates, dc_prev, dh_prev, din,
    c_new, out_blk, dout_p)."""
    num_units = c_prev.shape[-1]
    out_dim = dchain.shape[-1]
    cdt = wz.dtype
    gates = _with_gx0(_layer_matmul(z, wz, cdt) + bias[:, None, :], gx0_s)
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
    # outp feeds h_next (m·outp) and the chain (m·outp)
    dout_p = m * (dchain + dh)
    dout_blk = dout_p if proj is None else _layer_matmul(
        dout_p, proj.transpose(-1, -2), cdt)
    do = dout_blk * tc * so * (1.0 - so)
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
    dz = _layer_matmul(dgates, wz.transpose(-1, -2), cdt)
    din = rvec * dchain + dz[..., :out_dim]
    dh_prev = (1.0 - m) * dh + dz[..., out_dim:]
    return dgates, dc_prev, dh_prev, din, c_new, out_blk, dout_p


def _chain_cotangents(dout, din_above, drop):
    """dchain ``[S, L, B, P]``: layer l+1's din at s+1, plus dout on the last
    layer, times the dropout factors.  din_above ``[S, L, B, P]`` holds each
    layer's din (layer 0's unused)."""
    shifted = torch.cat([din_above[1:], torch.zeros_like(din_above[:1])])
    dchain = torch.cat([shifted[:, 1:], dout[:, None]], dim=1)
    return dchain if drop is None else dchain * drop


def _weight_grads(z, dgates, c_prev, c_new, out_blk, dout_p, cdt):
    """The stack backward's weight gradients over its per-step tensors
    ``[S, L, B, X]`` (dgates as stored): dwz = Σ zᵀ·dgates, dproj =
    Σ out_blkᵀ·dout_p (None when out_blk is) with operands rounded to
    ``cdt`` and float32 sums; dbias = Σ dgates and the peephole sums (None
    when c_new is), from dgates as stored."""
    steps, layers, batch, h4 = dgates.shape
    units = h4 // 4

    def per_layer(x):                       # [S, L, B, X] -> [L, S·B, X]
        return x.transpose(0, 1).reshape(layers, steps * batch, x.shape[-1])

    dwz = cells.matmul_f32(per_layer(z).transpose(1, 2), per_layer(dgates),
                           cdt)
    dproj = None
    if out_blk is not None:
        dproj = cells.matmul_f32(per_layer(out_blk).transpose(1, 2),
                                 per_layer(dout_p), cdt)
    dg32 = dgates.float()
    dbias = dg32.sum((0, 2))
    dpeep = None
    if c_new is not None:
        dpeep = torch.stack([
            (dg32[..., :units] * c_prev).sum((0, 2)),
            (dg32[..., 2 * units:3 * units] * c_prev).sum((0, 2)),
            (dg32[..., 3 * units:] * c_new).sum((0, 2))], dim=1)
    return dwz, dbias, dproj, dpeep


def stack_backward_reference(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                             residual, forget_bias: float, keep_prob, seed,
                             chain, c_all, h_all, dout, dcfin, dhfin,
                             store_dtype=torch.float32, steps_out=False):
    """Plain version of K13: the reverse wavefront, every layer each step.

    Arguments as ``stack_forward_reference``, with K12's stored streams
    (chain, c_all, h_all in ``store_dtype``) and the cotangents of its
    results: dout ``[S, B, P]``, dcfin ``[L·B, H]``, dhfin ``[L·B, P]``.
    Returns (dgates ``[S, L·B, 4H]`` in ``store_dtype`` (layer 0's rows are
    the cotangent of gx0), dwz ``[L, 2P, 4H]``, dbias ``[L, 4H]``, dproj
    ``[L, H, P]`` or None, dpeep ``[L, 3, H]`` or None, dcinit, dhinit),
    float32.  With ``steps_out``, also the carried cotangents entering each
    step, dc_in ``[S, L·B, H]`` and dh_in ``[S, L·B, P]``, and each layer's
    input cotangent din ``[L, S, B, P]`` (layer 0's zero).

    The weight gradients are summed over (s, b) after the loop with
    operands rounded to the compute dtype, as the TPU kernel sums them per
    time block: dwz = Σ [in_prev, h_prev]ᵀ·dgates, dproj = Σ out_blkᵀ·dout_p,
    dbias = Σ dgates, and the peephole sums, from dgates as stored."""
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    cdt = wz.dtype
    m_all = mask.view(steps, layers, batch, 1).float()
    rvec = _residual_vector(residual, layers, gx0.device)
    drop = _drop_mask(seed, keep_prob, steps, layers, batch, out_dim,
                      gx0.device)
    c_prev = _previous(c_all, cinit, layers)
    z = torch.cat([_inputs_before(chain, layers),
                   _previous(h_all, hinit, layers)], dim=-1)
    dout = dout.float()
    dc = dcfin.float().view(layers, batch, units)
    dh = dhfin.float().view(layers, batch, out_dim)
    din = gx0.new_zeros(layers, batch, out_dim)
    rows = {k: [] for k in ("dg", "c_new", "out_blk", "dout_p", "dc_in",
                            "dh_in", "din")}
    for s in range(steps - 1, -1, -1):
        rows["dc_in"].append(dc)
        rows["dh_in"].append(dh)
        # layer l's chain cotangent: layer l+1's din of the step after
        dchain = torch.cat([din[1:], dout[s][None]])
        if drop is not None:
            dchain = dchain * drop[s]
        dg, dc, dh, din, c_new, out_blk, dout_p = _backward_step(
            gx0[s], m_all[s], z[s], c_prev[s], dchain, dc, dh, wz, bias,
            proj, peep, rvec, forget_bias)
        rows["dg"].append(dg.to(store_dtype))
        rows["c_new"].append(c_new)
        rows["out_blk"].append(out_blk)
        rows["dout_p"].append(dout_p)
        rows["din"].append(din)
    st = {k: torch.stack(v[::-1]) for k, v in rows.items()}  # [S, L, B, X]

    dgates = st["dg"]
    dwz, dbias, dproj, dpeep = _weight_grads(
        z, dgates, c_prev, None if peep is None else st["c_new"],
        None if proj is None else st["out_blk"], st["dout_p"], cdt)
    lb = layers * batch
    result = (dgates.reshape(steps, lb, 4 * units), dwz, dbias, dproj, dpeep,
              dc.reshape(lb, units), dh.reshape(lb, out_dim))
    if steps_out:
        din_all = st["din"].transpose(0, 1).contiguous()
        din_all[0] = 0.0
        result += (st["dc_in"].reshape(steps, lb, units),
                   st["dh_in"].reshape(steps, lb, out_dim), din_all)
    return result


def stack_replay_backward_steps(gx0, mask, wz, bias, proj, peep, cinit,
                                hinit, residual, forget_bias: float,
                                keep_prob, seed, chain, c_all, h_all, dout,
                                dc_in, dh_in, din, store_dtype=torch.float32,
                                dgates=None):
    """Every step of the plain backward at once, each started from a
    kernel's own carried cotangents (dc_in, dh_in ``[S, L·B, ·]``) and its
    layers' input cotangents din ``[L, S, B, P]``.  Returns (dgates in
    ``store_dtype``, dc_out, dh_out, din_out): dc_out[s] and dh_out[s] are
    what step s carries on to step s-1 (to hold against dc_in[s-1] and
    dh_in[s-1]), din_out ``[L, S, B, P]`` against din.  With ``dgates`` (a
    kernel's own ``[S, L·B, 4H]``, as stored), also (dwz, dbias, dproj,
    dpeep) summed as ``stack_backward_reference`` sums them, over those
    dgates and the replayed steps' c_new, out_blk and dout_p: held against
    the kernel's weight gradients, this checks their products alone."""
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    drop = _drop_mask(seed, keep_prob, steps, layers, batch, out_dim,
                      gx0.device)
    z = torch.cat([_inputs_before(chain, layers),
                   _previous(h_all, hinit, layers)], dim=-1)
    dchain = _chain_cotangents(dout.float(), din.transpose(0, 1).float(),
                               drop)

    def view(x):
        return x.float().view(steps, layers, batch, x.shape[-1])

    c_prev = _previous(c_all, cinit, layers)
    dg, dc, dh, dinr, c_new, out_blk, dout_p = _backward_step(
        gx0, mask.view(steps, layers, batch, 1).float(), z, c_prev, dchain,
        view(dc_in), view(dh_in), wz, bias, proj, peep,
        _residual_vector(residual, layers, gx0.device), forget_bias)
    lb = layers * batch
    result = (dg.reshape(steps, lb, -1).to(store_dtype),
              dc.reshape(steps, lb, -1), dh.reshape(steps, lb, -1),
              dinr.transpose(0, 1))
    if dgates is None:
        return result
    return result + (_weight_grads(
        z, dgates.view(steps, layers, batch, -1), c_prev,
        None if peep is None else c_new, None if proj is None else out_blk,
        dout_p, wz.dtype),)


def _residual_bits(residual) -> int:
    return sum(1 << l for l, r in enumerate(residual) if r)


def _check_weights(gx0, mask, wz, bias, proj, peep, cinit, hinit):
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    device = gx0.device
    if gx0.dtype != torch.float32 or not gx0.is_contiguous():
        raise ValueError("gx0 must be a contiguous float32 [S, B, 4H]")
    if wz.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % wz.dtype)
    lb = layers * batch
    _expect(mask, (steps, lb), torch.float32, device, "mask")
    _expect(wz, (layers, 2 * out_dim, 4 * units), wz.dtype, device, "wz")
    _expect(bias, (layers, 4 * units), torch.float32, device, "bias")
    if proj is not None:
        _expect(proj, (layers, units, out_dim), wz.dtype, device, "proj")
    elif out_dim != units:
        raise ValueError("without a projection P must equal H")
    if peep is not None:
        _expect(peep, (layers, 3, units), torch.float32, device, "peep")
    _expect(cinit, (lb, units), torch.float32, device, "cinit")
    _expect(hinit, (lb, out_dim), torch.float32, device, "hinit")


def _input_rows(wx, cluster: int):
    """wx ``[L, P, 4H]`` as the stack kernels' cluster blocks read it for a
    layer's input products: block q's gate columns (units [q·US, (q+1)·US)
    of the four gates, in K1's slice order) as rows with the input index
    contiguous, ``[L, cluster, 4, US, P16]`` (P16: P rounded up to 16),
    zero-padded."""
    layers, out_dim, h4 = wx.shape
    units = h4 // 4
    us = _round_up(-(-units // cluster), 8)
    rows = F.pad(wx.reshape(layers, out_dim, 4, units),
                 (0, cluster * us - units, 0, 0,
                  0, _round_up(out_dim, 16) - out_dim))
    rows = rows.view(layers, rows.shape[1], 4, cluster, us)
    return rows.permute(0, 3, 2, 4, 1).contiguous()


def stack_slices(wz, proj, cluster: int, backward: bool = False,
                 streamed: bool = False) -> Dict:
    """The stack's weights cut per block of a ``cluster``-block cluster (8
    or 16, as the kernel's plan answers), made once per weight tensor,
    cluster size and layout (``cells.derived``): ``wh_sl`` as K1's slices
    (with ``streamed``, each row padded as K1's streamed plan pads it); for
    K12 ``wx_rows`` (``_input_rows``) and ``proj_sl`` as K1's slices; for
    K13 (``backward``) ``proj_rows`` as K2's (padded as K2's streamed plan
    pads them; K13 reads wx from wz itself).  8 blocks own at most 64 units
    each (512 units), 16 at most 128 (2048)."""
    out_dim = wz.shape[1] // 2
    sources = [t for t in (wz, proj) if t is not None]

    def build():
        wh_sl, proj_sl = _slices(wz[:, out_dim:], proj, cluster, streamed,
                                 block_units=LAYER_BLOCK_UNITS * cluster // 16)
        if backward:
            return {"wh_sl": wh_sl, "proj_rows": None if proj is None
                    else _proj_rows(proj, cluster, streamed)}
        return {"wx_rows": _input_rows(wz[:, :out_dim], cluster),
                "wh_sl": wh_sl, "proj_sl": proj_sl}

    return cells.derived(sources, ("stack slices", cluster, backward,
                                   streamed), build)


def stack_config(device, steps: int, layers: int, batch: int, units: int,
                 out_dim: int, has_proj: bool, dtype, backward: bool = False,
                 store_dtype=torch.float32) -> dict:
    """How K12 (or, with ``backward``, K13) launches on ``device`` at this
    shape: ``blocks`` (a cluster: 8, or 16 where no 8-block plan fits),
    ``rows`` (batch rows a cluster; 0 when the card cannot hold the L
    clusters of a row tile at once), ``tiles`` (row tiles), ``per_wave``
    (row tiles a launch, all L layers of each resident together),
    ``waves``, ``lag`` (the chunk of steps a layer runs ahead of the next),
    ``smem_bytes`` (shared memory a block), ``resident`` (clusters the card
    holds at once), ``streamed`` (the streamed plan or not), a block's
    weight bytes ``held_bytes`` in shared memory and ``streamed_bytes``
    read from L2 at every step (float32 reads all its slices), and
    ``scratch_floats``, as the launcher chooses them.  Raises where the
    shape has no plan."""
    how = dict(_config(device.index or 0, steps, layers, batch, units,
                       out_dim, bool(has_proj), dtype == torch.bfloat16,
                       backward, store_dtype == torch.bfloat16))
    how["streamed"] = bool(how["streamed"])
    return how


@functools.lru_cache(maxsize=256)
def _config(device: int, steps, layers, batch, units, out_dim, has_proj,
            bf16, backward, store_bf16):
    """``stack_config`` once per shape: the launcher's choice depends only
    on these and on the device."""
    lib = _build.library()
    keys = ("blocks", "rows", "tiles", "per_wave", "waves", "lag",
            "smem_bytes", "resident", "streamed", "held_bytes",
            "streamed_bytes")
    info = (ctypes.c_longlong * len(keys))()
    scratch = ctypes.c_longlong()
    args = [device, steps, layers, batch, units, out_dim, int(has_proj),
            int(bf16)]
    if backward:
        err = lib.lstm_stack_bwd_config(*args, int(store_bf16), info,
                                        ctypes.byref(scratch))
    else:
        err = lib.lstm_stack_fwd_config(*args, info, ctypes.byref(scratch))
    _build.check(err, "lstm_stack_%s_config" % ("bwd" if backward else "fwd"))
    return tuple(zip(keys, list(info))) + (("scratch_floats", scratch.value),)


def _forced_plan(plan, dtype):
    """(streamed layout or not, extra launch arguments) of a forced plan
    (a name of ``lstm_kernels.PLANS`` and R), or (None, []) without one."""
    if plan is None:
        return None, []
    if dtype != torch.bfloat16:
        raise ValueError("a forced plan is a bf16 launch")
    return plan[0] != "resident", [PLANS[plan[0]], int(plan[1])]


def _held(how: dict, layers: int, what: str) -> None:
    """Raise unless the card holds a row tile's ``layers`` clusters at once
    (``stack_eligible`` routes such a stack before it gets here)."""
    if not how["rows"]:
        raise RuntimeError("%s: the card holds %d of the stack's clusters at "
                           "once, fewer than its %d layers"
                           % (what, how["resident"], layers))


def lstm_stack_forward(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                       residual, forget_bias: float, keep_prob: float = 1.0,
                       seed=None, affine=None, states: bool = False,
                       store_dtype=torch.float32, _plan=None):
    """The stack's forward (K12).  Arguments and results as
    ``stack_forward_reference``: (out, cfin, hfin), and with ``states``
    also (chain, c_all, h_all) in ``store_dtype``.  ``_plan`` = (a name of
    ``lstm_kernels.PLANS``, R) forces a bf16 launch onto that plan and R,
    to hold the plans against each other (``csrc/lstm_stack_fwd.cu``
    ``forced``)."""
    if store_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("store dtype must be float32 or bfloat16, got %s"
                         % store_dtype)
    if gx0.device.type == "cpu":
        out, chain, c_all, h_all, cfin, hfin = stack_forward_reference(
            gx0, mask, wz, bias, proj, peep, cinit, hinit, residual,
            forget_bias, keep_prob, seed, affine, store_dtype)
        return (out, cfin, hfin) + ((chain, c_all, h_all) if states else ())
    if gx0.device.type != "cuda":
        raise ValueError("lstm_stack_forward: unsupported device %s"
                         % gx0.device)
    _check_weights(gx0, mask, wz, bias, proj, peep, cinit, hinit)
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    device = gx0.device
    aff_a = aff_b = None
    if affine is not None:
        aff_a, aff_b = (t.float().contiguous() for t in affine)
        _expect(aff_a, (layers, out_dim), torch.float32, device, "affine a")
        _expect(aff_b, (layers, out_dim), torch.float32, device, "affine b")
    lib = _build.library()
    how = stack_config(device, steps, layers, batch, units, out_dim,
                       proj is not None, wz.dtype)
    _held(how, layers, "lstm_stack_fwd")
    streamed, forced = _forced_plan(_plan, wz.dtype)
    sl = stack_slices(wz, proj, how["blocks"],
                      streamed=how["streamed"] if streamed is None
                      else streamed)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype)

    lb = layers * batch
    out = empty(steps, batch, out_dim)
    cfin, hfin = empty(lb, units), empty(lb, out_dim)
    chain = c_all = h_all = None
    if states:
        chain = empty(steps, lb, out_dim, dtype=store_dtype)
        c_all = empty(steps, lb, units, dtype=store_dtype)
        h_all = empty(steps, lb, out_dim, dtype=store_dtype)
    scratch = empty(how["scratch_floats"])
    launch = lib.lstm_stack_fwd_bf16 if wz.dtype == torch.bfloat16 \
        else lib.lstm_stack_fwd_f32
    if forced:
        launch = lib.lstm_stack_fwd_bf16_forced
    err = launch(device.index or 0, _seed_ptr(seed, keep_prob, device),
                 _ptr(gx0), _ptr(mask), _ptr(sl["wx_rows"]), _ptr(sl["wh_sl"]),
                 _ptr(sl["proj_sl"]), _ptr(bias), _ptr(peep), _ptr(cinit),
                 _ptr(hinit), _ptr(aff_a), _ptr(aff_b), float(forget_bias),
                 float(keep_prob), _residual_bits(residual), steps, layers,
                 batch, units, out_dim, _ptr(out), _ptr(chain), _ptr(c_all),
                 _ptr(h_all), int(store_dtype == torch.bfloat16), _ptr(cfin),
                 _ptr(hfin), _ptr(scratch),
                 torch.cuda.current_stream(device).cuda_stream, *forced)
    _build.check(err, "lstm_stack_fwd")
    lstm_stack_forward.launches += 1
    return (out, cfin, hfin) + ((chain, c_all, h_all) if states else ())


lstm_stack_forward.launches = 0


def lstm_stack_backward(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                        residual, forget_bias: float, keep_prob, seed, chain,
                        c_all, h_all, dout, dcfin, dhfin,
                        store_dtype=torch.float32, steps_out: bool = False,
                        _plan=None):
    """The stack's backward (K13).  Arguments and results as
    ``stack_backward_reference``; ``_plan`` as ``lstm_stack_forward``'s
    (``csrc/lstm_stack_bwd.cu`` ``forced``)."""
    if gx0.device.type == "cpu":
        return stack_backward_reference(
            gx0, mask, wz, bias, proj, peep, cinit, hinit, residual,
            forget_bias, keep_prob, seed, chain, c_all, h_all, dout, dcfin,
            dhfin, store_dtype, steps_out)
    if gx0.device.type != "cuda":
        raise ValueError("lstm_stack_backward: unsupported device %s"
                         % gx0.device)
    _check_weights(gx0, mask, wz, bias, proj, peep, cinit, hinit)
    steps, layers, batch, units, out_dim = _dims(gx0, wz)
    if units % 4 or out_dim % 4:
        raise ValueError("the backward kernel takes H and P divisible by 4, "
                         "got H=%d P=%d" % (units, out_dim))
    device, lb, h4 = gx0.device, layers * batch, 4 * units
    _expect(chain, (steps, lb, out_dim), store_dtype, device, "chain")
    _expect(c_all, (steps, lb, units), store_dtype, device, "c_all")
    _expect(h_all, (steps, lb, out_dim), store_dtype, device, "h_all")
    dout = dout.float().contiguous()
    dcfin = dcfin.float().contiguous()
    dhfin = dhfin.float().contiguous()
    _expect(dout, (steps, batch, out_dim), torch.float32, device, "dout")
    _expect(dcfin, (lb, units), torch.float32, device, "dcfin")
    _expect(dhfin, (lb, out_dim), torch.float32, device, "dhfin")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype)

    lib = _build.library()
    how = stack_config(device, steps, layers, batch, units, out_dim,
                       proj is not None, wz.dtype, backward=True,
                       store_dtype=store_dtype)
    _held(how, layers, "lstm_stack_bwd")
    streamed, forced = _forced_plan(_plan, wz.dtype)
    sl = stack_slices(wz, proj, how["blocks"], backward=True,
                      streamed=how["streamed"] if streamed is None
                      else streamed)
    dgates = empty(steps, lb, h4, dtype=store_dtype)
    outb = doutp = dproj = None
    if proj is not None:
        # the dproj product's operands, stashed in the compute dtype
        outb = empty(steps, lb, units, dtype=wz.dtype)
        doutp = empty(steps, lb, out_dim, dtype=wz.dtype)
        dproj = empty(layers, units, out_dim)
    dcinit, dhinit = empty(lb, units), empty(lb, out_dim)
    din = empty(layers, steps, batch, out_dim)
    dc_in = dh_in = None
    if steps_out:
        din[0] = 0.0
        dc_in, dh_in = empty(steps, lb, units), empty(steps, lb, out_dim)
    dwz = empty(layers, 2 * out_dim, h4)
    dcols = empty(layers, h4 + 3 * units)
    scratch = empty(how["scratch_floats"])
    launch = lib.lstm_stack_bwd_bf16 if wz.dtype == torch.bfloat16 \
        else lib.lstm_stack_bwd_f32
    if forced:
        launch = lib.lstm_stack_bwd_bf16_forced
    err = launch(device.index or 0, _seed_ptr(seed, keep_prob, device),
                 _ptr(gx0), _ptr(mask), _ptr(chain), _ptr(c_all),
                 _ptr(h_all), _ptr(cinit), _ptr(hinit), _ptr(wz),
                 _ptr(sl["wh_sl"]), _ptr(sl["proj_rows"]),
                 _ptr(bias), _ptr(peep), float(forget_bias),
                 float(keep_prob), _residual_bits(residual), _ptr(dout),
                 _ptr(dcfin), _ptr(dhfin), steps, layers, batch, units,
                 out_dim, int(store_dtype == torch.bfloat16), _ptr(dgates),
                 _ptr(outb), _ptr(doutp), _ptr(dcinit), _ptr(dhinit),
                 _ptr(din), _ptr(dc_in), _ptr(dh_in), _ptr(dwz), _ptr(dproj),
                 _ptr(dcols), _ptr(scratch),
                 torch.cuda.current_stream(device).cuda_stream, *forced)
    _build.check(err, "lstm_stack_bwd")
    lstm_stack_backward.launches += 1
    dpeep = None if peep is None else dcols[:, h4:].reshape(layers, 3, units)
    result = (dgates, dwz, dcols[:, :h4], dproj, dpeep, dcinit, dhinit)
    return result + ((dc_in, dh_in, din) if steps_out else ())


lstm_stack_backward.launches = 0


class _LstmStack(torch.autograd.Function):
    """The stack under autograd: K12 with its per-step streams stored in
    the store dtype, and K13 for the backward (``fused`` / ``fused_bwd``)."""

    @staticmethod
    def forward(ctx, gx0, wz, bias, proj, peep, cinit, hinit, mask, seed,
                residual, keep_prob, forget_bias, store_dtype):
        out, cfin, hfin, chain, c_all, h_all = lstm_stack_forward(
            gx0, mask, wz, bias, proj, peep, cinit, hinit, residual,
            forget_bias, keep_prob, seed, states=True,
            store_dtype=store_dtype)
        ctx.save_for_backward(gx0, wz, bias, proj, peep, cinit, hinit, mask,
                              seed, chain, c_all, h_all)
        ctx.args = (residual, forget_bias, keep_prob, store_dtype)
        return out, cfin, hfin

    @staticmethod
    def backward(ctx, dout, dcfin, dhfin):
        (gx0, wz, bias, proj, peep, cinit, hinit, mask, seed, chain, c_all,
         h_all) = ctx.saved_tensors
        residual, forget_bias, keep_prob, store_dtype = ctx.args
        dgates, dwz, dbias, dproj, dpeep, dcinit, dhinit = \
            lstm_stack_backward(gx0, mask, wz, bias, proj, peep, cinit, hinit,
                                residual, forget_bias, keep_prob, seed, chain,
                                c_all, h_all, dout, dcfin, dhfin,
                                store_dtype=store_dtype)
        batch = gx0.shape[1]
        return (dgates[:, :batch].float(), dwz.to(wz.dtype), dbias,
                None if dproj is None else dproj.to(proj.dtype), dpeep,
                dcinit, dhinit) + (None,) * 6


class _LstmStackAffine(torch.autograd.Function):
    """The eval-mode BN stack (chain affines): forward only, as the TPU
    path's ``fused_affine`` (:505-528)."""

    @staticmethod
    def forward(ctx, gx0, wz, bias, proj, peep, cinit, hinit, mask, a, b,
                residual, forget_bias):
        return lstm_stack_forward(gx0, mask, wz, bias, proj, peep, cinit,
                                  hinit, residual, forget_bias,
                                  affine=(a, b))

    @staticmethod
    def backward(ctx, *cots):
        raise NotImplementedError(
            "the affine (eval-mode BN) stack kernel is forward-only; "
            "gradients of an eval forward are not supported: run with "
            "train=True (training-mode BN takes the per-layer path)")


def lstm_stack_fused(params_list: List[Dict], x, sequence_length,
                     forget_bias: float = 1.0, residual_flags=None,
                     compute_dtype=None, store_dtype=torch.bfloat16,
                     initial_states=None, keep_prob: float = 1.0, seed=None,
                     affine=None):
    """Run the whole unidirectional stack through K12 (and K13 under
    autograd), as ``lstm_stack_pallas.lstm_stack_fused``.

    params_list: one ``cells.init_lstm_cell`` dict per layer
    (``stack_eligible``); x ``[B, T, D]``; residual_flags per-layer bools
    (layer l's chain = masked output + (flag ? input : 0)); initial_states
    optional ``[(c_l, h_l)]`` (chunk-carried streaming state); keep_prob < 1
    drops the chain values with the hash mask of ``seed`` (an int32 tensor
    of one element on x's device); affine optional per-layer ``[(a_l, b_l)]``
    applying chain·a + b after the residual (eval-mode BN, forward only).
    Returns (outputs ``[B, T, P]``, ``[(c_l, h_l)]`` final states)."""
    layers = len(params_list)
    batch, time_steps, _ = x.shape
    p0 = params_list[0]
    units = p0["bias"].shape[0] // 4
    out_dim = p0["proj"].shape[1] if "proj" in p0 else units
    cdt = compute_dtype or x.dtype
    residual = tuple(bool(r) for r in (residual_flags or (False,) * layers))
    if affine is not None and keep_prob < 1.0:
        raise ValueError("the affine (eval-mode BN) stack is forward-only; "
                         "no dropout")
    wz, bias, proj, peep = stack_weights(params_list, cdt)
    # layer 0's input projection: one GEMM for the whole sequence
    gx = torch.matmul(x.to(cdt), p0["wx"].to(cdt)).float() + p0["bias"]
    gx0 = F.pad(gx.transpose(0, 1), (0, 0, 0, 0, 0, layers - 1)).contiguous()
    mask = stack_mask(sequence_length, time_steps, layers, x.device)
    if initial_states is None:
        cinit = x.new_zeros(layers * batch, units, dtype=torch.float32)
        hinit = x.new_zeros(layers * batch, out_dim, dtype=torch.float32)
    else:
        cinit = torch.cat([c.float() for c, _ in initial_states]).contiguous()
        hinit = torch.cat([h.float() for _, h in initial_states]).contiguous()
    if keep_prob >= 1.0:
        seed = None
    inputs = (gx0, wz, bias, proj, peep, cinit, hinit)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    if affine is not None:
        a = torch.stack([v for v, _ in affine]).float().contiguous()
        b = torch.stack([v for _, v in affine]).float().contiguous()
        if grad:
            out, cfin, hfin = _LstmStackAffine.apply(*inputs, mask, a, b,
                                                     residual,
                                                     float(forget_bias))
        else:
            out, cfin, hfin = lstm_stack_forward(
                gx0, mask, wz, bias, proj, peep, cinit, hinit, residual,
                forget_bias, affine=(a, b))
    elif grad:
        out, cfin, hfin = _LstmStack.apply(*inputs, mask, seed, residual,
                                           float(keep_prob),
                                           float(forget_bias), store_dtype)
    else:
        out, cfin, hfin = lstm_stack_forward(
            gx0, mask, wz, bias, proj, peep, cinit, hinit, residual,
            forget_bias, keep_prob, seed)
    outputs = out[layers - 1:layers - 1 + time_steps].transpose(0, 1)
    states = [(cfin[l * batch:(l + 1) * batch],
               hfin[l * batch:(l + 1) * batch]) for l in range(layers)]
    return outputs, states
