"""K12's and K13's partition of the stack (``csrc/lstm_stack_fwd.cu``,
``csrc/lstm_stack_bwd.cu``), on the CPU.

Both kernels run one cluster of 8 blocks (16 where no 8-block plan fits,
up to 1024 units) per (layer, tile of R batch rows): block q owns hidden
units [q·US, (q+1)·US) and holds its slices of wh and proj and its rows
of wx (``lstm_stack_kernels.stack_slices``); the layers run as a pipeline
in chunks of K steps (the lag), the row tiles in waves.  Here the slices
are checked to reassemble to the weights exactly with 8 and 16 blocks,
and a plain emulation of the partition is held to
``stack_forward_reference`` and ``stack_backward_reference`` at rtol =
atol = 1e-5 in float32: each layer's input products (K12's a chunk at a
time from the block's rows of wx, K13's one product a layer before the
recurrence), din produced a chunk at a time from the chunk's dgates,
dh_prev as the sum of the blocks' partials in block order, the column sums
per row tile added in tile order, and the row tiles in waves.  The layers'
hand-offs are emulated block by block: what a block of a layer writes
for the next layer (its columns of the chain; in the backward its P-slice
of din) becomes readable only when that block publishes its count, each
layer runs a chunk only once every block of the layer it reads from has
counted what the chunk needs, and a scheduler interleaves the chunks and
the publishes of the layers (the wavefront order, random orders, and one
that publishes only when nothing else can run).  A wait on fewer than
all the blocks, or on too few steps, reads values not yet published.
"""

import random

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk

CLUSTERS = [8, 16]
TOL = dict(rtol=1e-5, atol=1e-5)


def cdiv(a, b):
    return -(-a // b)


def round_up(v, m):
    return cdiv(v, m) * m


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's thousands of small ops
    slow down when their thread pool shares busy cores (the suite's
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_case(seed, batch=5, time_steps=12, units=16, proj=12, dim=10,
              layers=3, keep=1.0, affine=False, init=False, residual=True,
              peepholes=True):
    gen = torch.Generator().manual_seed(seed)
    params, d = [], dim
    for _ in range(layers):
        params.append(cells.init_lstm_cell(gen, d, units, proj, peepholes))
        d = proj or units
    rng = np.random.RandomState(seed)
    for p in params:
        p["bias"] = torch.from_numpy(
            (0.1 * rng.randn(p["bias"].shape[0])).astype(np.float32))
    x = torch.from_numpy(rng.randn(batch, time_steps, dim).astype(np.float32))
    lengths = rng.randint(time_steps // 2, time_steps + 1, batch)
    lengths[0] = time_steps
    seq = torch.from_numpy(lengths.astype(np.int32))
    wz, bias, proj_w, peep = sk.stack_weights(params, torch.float32)
    gx = torch.matmul(x, params[0]["wx"]) + params[0]["bias"]
    gx0 = torch.nn.functional.pad(gx.transpose(0, 1),
                                  (0, 0, 0, 0, 0, layers - 1)).contiguous()
    out_dim, lb = proj or units, layers * batch
    scale = 0.1 if init else 0.0
    aff = None
    if affine:
        aff = (torch.from_numpy((0.5 + rng.rand(layers, out_dim)).astype(
            np.float32)), torch.from_numpy((0.2 * rng.randn(
                layers, out_dim)).astype(np.float32)))
    return dict(
        gx0=gx0, mask=sk.stack_mask(seq, time_steps, layers, "cpu"), wz=wz,
        bias=bias, proj=proj_w, peep=peep,
        cinit=torch.from_numpy((scale * rng.randn(lb, units)).astype(
            np.float32)),
        hinit=torch.from_numpy((scale * rng.randn(lb, out_dim)).astype(
            np.float32)),
        residual=(False,) + (residual,) * (layers - 1), forget_bias=1.0,
        keep_prob=keep, seed=torch.tensor([-1234567], dtype=torch.int32),
        affine=aff)


@pytest.mark.parametrize("units,proj,cluster", [
    (320, 320, 8), (320, None, 8), (16, 12, 8), (384, 384, 16),
    (1024, 256, 16), (512, None, 16), (16, 12, 16)])
def test_stack_slices_reassemble_to_the_weights(units, proj, cluster):
    case = make_case(0, batch=2, time_steps=3, units=units, proj=proj,
                     dim=8, layers=2)
    wz, pj = case["wz"], case["proj"]
    layers, p2, h4 = wz.shape
    out_dim = p2 // 2
    sl = sk.stack_slices(wz, pj, cluster)
    bsl = sk.stack_slices(wz, pj, cluster, backward=True)
    assert torch.equal(bsl["wh_sl"], sl["wh_sl"])
    us = sl["wh_sl"].shape[-1]
    p16 = -(-out_dim // 16) * 16
    assert us % 8 == 0 and cluster * us >= units and us <= 64
    assert us == round_up(cdiv(units, cluster), 8)
    # wx rows: block q's gate columns (units [q·US, (q+1)·US) of each gate)
    # with the input index contiguous
    rows = sl["wx_rows"]
    assert rows.shape == (layers, cluster, 4, us, p16)
    full = rows.permute(0, 4, 2, 1, 3).reshape(layers, p16, 4, cluster * us)
    assert torch.equal(full[:, :out_dim, :, :units],
                       wz[:, :out_dim].view(layers, out_dim, 4, units))
    assert not full[:, out_dim:].any() and not full[..., units:].any()
    # wh slices as K1's
    wh = sl["wh_sl"]
    assert wh.shape == (layers, cluster, p16, 4, us)
    full = wh.permute(0, 2, 3, 1, 4).reshape(layers, p16, 4, cluster * us)
    assert torch.equal(full[:, :out_dim, :, :units],
                       wz[:, out_dim:].view(layers, out_dim, 4, units))
    assert not full[:, out_dim:].any() and not full[..., units:].any()
    if pj is None:
        assert sl["proj_sl"] is None and bsl["proj_rows"] is None
        return
    # proj as K1's column slices (K12) and K2's rows (K13)
    ps, h16 = sl["proj_sl"].shape[-1], -(-units // 16) * 16
    assert ps == round_up(cdiv(out_dim, cluster), 16)
    assert sl["proj_sl"].shape == (layers, cluster, h16, ps)
    cols = sl["proj_sl"].permute(0, 2, 1, 3).reshape(layers, h16,
                                                     cluster * ps)
    assert torch.equal(cols[:, :units, :out_dim], pj)
    assert not cols[:, units:].any() and not cols[..., out_dim:].any()
    u16 = -(-us // 16) * 16
    prow = bsl["proj_rows"]
    assert prow.shape == (layers, cluster, u16, p16)
    assert torch.equal(prow[:, :, :us].reshape(layers, cluster * us, p16)
                       [:, :units, :out_dim], pj)
    assert not prow[:, :, us:].any() and not prow[..., out_dim:].any()
    # made once per weight tensor and cluster size
    assert sk.stack_slices(wz, pj, cluster) is sl
    assert sk.stack_slices(wz, pj, cluster, backward=True) is bsl
    if units <= 512:   # 8 blocks hold at most 512 units
        other = 24 - cluster
        assert sk.stack_slices(wz, pj, other)["wh_sl"].shape[1] == other
    else:
        with pytest.raises(ValueError, match="at most 512 units"):
            sk.stack_slices(wz, pj, 8)


def _drop(case, steps, layers, batch, out_dim):
    return sk._drop_mask(case["seed"], case["keep_prob"], steps, layers,
                         batch, out_dim, "cpu")


def _waves(batch, rows, per_wave):
    tiles = [list(range(b0, min(batch, b0 + rows)))
             for b0 in range(0, batch, rows)]
    return [tiles[i:i + per_wave] for i in range(0, len(tiles), per_wave)]


def _units(q, us, units):
    return torch.arange(min(units, q * us), min(units, (q + 1) * us))


def _block_input(x, rows_q, nu):
    """x [n, P] · the block's wx rows [4, US, P16] -> [n, 4, nu]."""
    w = rows_q[:, :nu, :x.shape[1]]
    return torch.einsum("np,kjp->nkj", x, w)


class Pipeline:
    """The layers of one row tile as the kernels run them: each layer's
    chunks in order, each chunk's results published block by block.
    ``need(l, ck)`` is what layer l's chunk ck waits for: the count every
    block of the layer it reads from must have published (None: nothing);
    ``run(l, ck)`` computes the chunk into the layer's own buffers and
    returns each block's columns to publish; ``publish(l, ck, q, cols)``
    makes them readable.  ``order`` picks the next action among those that
    can run: "wavefront" (a layer's chunk as soon as it can, publishes at
    once in block order), "random<n>" (a seeded random choice), or "lazy"
    (publishes only when no chunk can run, the last block first).  A layer
    waits on the ``watched`` blocks of the layer it reads from (all of
    them, as the kernels do)."""

    def __init__(self, layers, chunks, cluster, order, watched=None):
        self.layers, self.chunks, self.cluster = layers, chunks, cluster
        self.order = order
        self.watched = list(range(cluster) if watched is None else watched)
        self.rng = random.Random(int(order[6:]) if order.startswith(
            "random") else 0)

    def drive(self, need, run, publish, source):
        """``source(l)``: the layer layer l reads from (None for none)."""
        nxt = [0] * self.layers               # each layer's next chunk
        counted = [[0] * self.cluster for _ in range(self.layers)]
        pending = []                          # (l, ck, q, cols, count)
        while min(nxt) < self.chunks or pending:
            runnable = []
            for l in range(self.layers):
                ck = nxt[l]
                if ck >= self.chunks or any(p[0] == l for p in pending):
                    continue
                want = need(l, ck)
                src = source(l)
                if want is None or src is None or min(
                        counted[src][q] for q in self.watched) >= want:
                    runnable.append(l)
            if self.order == "wavefront":
                actions = [("run", runnable[0])] if runnable else [
                    ("publish", 0)]
            elif self.order == "lazy":
                actions = [("run", runnable[-1])] if runnable else [
                    ("publish", len(pending) - 1)]
            else:
                actions = [("run", l) for l in runnable] + [
                    ("publish", i) for i in range(len(pending))]
                actions = [self.rng.choice(actions)]
            kind, arg = actions[0]
            if kind == "run":
                ck = nxt[arg]
                for q, cols, count in run(arg, ck):
                    pending.append((arg, ck, q, cols, count))
                nxt[arg] += 1
                if self.order == "wavefront":
                    while pending:
                        l, ck, q, cols, count = pending.pop(0)
                        publish(l, ck, q, cols)
                        counted[l][q] = count
            else:
                l, ck, q, cols, count = pending.pop(arg)
                publish(l, ck, q, cols)
                counted[l][q] = count


def _out_cols(q, cluster, units, out_dim, has_proj, us):
    """The chain columns block q writes: its projection columns, or its
    units without a projection."""
    if has_proj:
        ps = round_up(cdiv(out_dim, cluster), 16)
        return torch.arange(min(out_dim, q * ps), min(out_dim, (q + 1) * ps))
    return _units(q, us, units)


def pipeline_forward(case, rows, lag, per_wave, cluster=8,
                     order="wavefront", watched=None):
    """K12's partition in plain torch: (out, chain, c_all, h_all, cfin,
    hfin), float32."""
    gx0, wz, proj = case["gx0"], case["wz"], case["proj"]
    steps, batch, h4 = gx0.shape
    layers, units, out_dim = wz.shape[0], h4 // 4, wz.shape[1] // 2
    lb = layers * batch
    sl = sk.stack_slices(wz, proj, cluster)
    us = sl["wh_sl"].shape[-1]
    ps = sl["proj_sl"].shape[-1] if proj is not None else us
    mask = case["mask"].view(steps, layers, batch)
    drop = _drop(case, steps, layers, batch, out_dim)
    peep = case["peep"]
    chain = torch.zeros(steps, layers, batch, out_dim)   # the results
    seen = torch.zeros(steps, layers, batch, out_dim)    # published chains
    c_all = torch.zeros(steps, layers, batch, units)
    h_all = torch.zeros(steps, layers, batch, out_dim)
    cfin = torch.zeros(layers, batch, units)
    hfin = torch.zeros(layers, batch, out_dim)
    chunks = -(-steps // lag)
    for wave in _waves(batch, rows, per_wave):
        for tile in wave:
            b = torch.tensor(tile)
            state = {}
            for l in range(layers):
                c = case["cinit"].view(layers, batch, units)[l, b].clone()
                h = case["hinit"].view(layers, batch, out_dim)[l, b].clone()
                state[l] = (c, h)

            def need(l, ck):
                # the chunk's input product reads layer l-1's chains up to
                # its last step but one (wait_blocks(below, s1 - 1))
                return min(steps, (ck + 1) * lag) - 1 if l > 0 else None

            def run(l, ck):
                s0, s1 = ck * lag, min(steps, (ck + 1) * lag)
                gx = torch.zeros(s1 - s0, len(tile), 4, units)
                for s in range(s0, s1):
                    if l == 0:
                        gx[s - s0] = gx0[s, b].view(-1, 4, units)
                if l > 0:  # the chunk's input product, block by block
                    prev = torch.stack([
                        seen[s - 1, l - 1, b] if s > 0 else
                        torch.zeros(len(tile), out_dim)
                        for s in range(s0, s1)]).reshape(-1, out_dim)
                    for q in range(cluster):
                        u = _units(q, us, units)
                        if len(u) == 0:
                            continue
                        part = _block_input(prev, sl["wx_rows"][l, q], len(u))
                        gx[..., u] = (part.view(s1 - s0, len(tile), 4, len(u))
                                      + case["bias"][l].view(4, units)[:, u])
                c, h = state[l]
                for s in range(s0, s1):
                    m = mask[s, l, b][:, None]
                    cell = torch.zeros(len(tile), units)
                    c_new = c.clone()
                    for q in range(cluster):
                        u = _units(q, us, units)
                        if len(u) == 0:
                            continue
                        w = sl["wh_sl"][l, q, :out_dim, :, :len(u)]
                        g = gx[s - s0][..., u] + torch.einsum(
                            "rp,pkj->rkj", h, w)
                        gi, gj, gf, go = g.unbind(1)
                        c0 = c[:, u]
                        if peep is not None:
                            gi = gi + peep[l, 0, u] * c0
                            gf = gf + peep[l, 1, u] * c0
                        cn = torch.sigmoid(gf + case["forget_bias"]) * c0 \
                            + torch.sigmoid(gi) * torch.tanh(gj)
                        if peep is not None:
                            go = go + peep[l, 2, u] * cn
                        cell[:, u] = torch.sigmoid(go) * torch.tanh(cn)
                        c_new[:, u] = m * cn + (1 - m) * c0
                    if proj is None:
                        o = cell
                    else:
                        o = torch.zeros(len(tile), out_dim)
                        for q in range(cluster):
                            p = torch.arange(min(out_dim, q * ps),
                                             min(out_dim, (q + 1) * ps))
                            if len(p):
                                o[:, p] = cell @ sl["proj_sl"][
                                    l, q, :units, :len(p)]
                    h = m * o + (1 - m) * h
                    c = c_new
                    ch = m * o
                    if case["residual"][l] and s > 0:
                        ch = ch + seen[s - 1, l - 1, b]
                    if drop is not None:
                        ch = ch * drop[s, l, b]
                    if case["affine"] is not None:
                        ch = ch * case["affine"][0][l] + case["affine"][1][l]
                    chain[s, l, b], c_all[s, l, b], h_all[s, l, b] = ch, c, h
                state[l] = (c, h)
                return [(q, _out_cols(q, cluster, units, out_dim,
                                      proj is not None, us), s1)
                        for q in range(cluster)]

            def publish(l, ck, q, cols):
                s0, s1 = ck * lag, min(steps, (ck + 1) * lag)
                idx = (slice(s0, s1), l, b[:, None], cols[None, :])
                seen[idx] = chain[idx]

            Pipeline(layers, chunks, cluster, order, watched).drive(
                need, run, publish, lambda l: l - 1 if l > 0 else None)
            for l in range(layers):
                cfin[l, b], hfin[l, b] = state[l]
    return (chain[:, -1].contiguous(), chain.reshape(steps, lb, out_dim),
            c_all.reshape(steps, lb, units), h_all.reshape(steps, lb, out_dim),
            cfin.reshape(lb, units), hfin.reshape(lb, out_dim))


def pipeline_backward(case, fwd, dout, dcfin, dhfin, rows, lag, per_wave,
                      cluster=8, order="wavefront"):
    """K13's partition in plain torch: (dgates, dwz, dbias, dproj, dpeep,
    dcinit, dhinit, din), float32."""
    gx0, wz, proj, peep = case["gx0"], case["wz"], case["proj"], case["peep"]
    steps, batch, h4 = gx0.shape
    layers, units, out_dim = wz.shape[0], h4 // 4, wz.shape[1] // 2
    lb = layers * batch
    _, chain, c_all, h_all, _, _ = fwd
    sl = sk.stack_slices(wz, proj, cluster, backward=True)
    us = sl["wh_sl"].shape[-1]
    ps = round_up(cdiv(out_dim, cluster), 4)
    mask = case["mask"].view(steps, layers, batch)
    drop = _drop(case, steps, layers, batch, out_dim)
    chain4 = chain.view(steps, layers, batch, out_dim)
    c4 = c_all.view(steps, layers, batch, units)
    h4_all = h_all.view(steps, layers, batch, out_dim)
    cinit = case["cinit"].view(layers, batch, units)
    hinit = case["hinit"].view(layers, batch, out_dim)
    dgates = torch.zeros(steps, layers, batch, h4)
    din = torch.zeros(layers, steps, batch, out_dim)       # the results
    seen = torch.zeros(layers, steps, batch, out_dim)      # published din
    dcinit = torch.zeros(layers, batch, units)
    dhinit = torch.zeros(layers, batch, out_dim)
    c_new_all = torch.zeros(steps, layers, batch, units)
    out_blk = torch.zeros(steps, layers, batch, units)
    dout_p_all = torch.zeros(steps, layers, batch, out_dim)
    col_parts = []
    chunks = -(-steps // lag)

    def p_slice(q):
        return torch.arange(min(out_dim, q * ps), min(out_dim, (q + 1) * ps))

    for wave in _waves(batch, rows, per_wave):
        for tile in wave:
            b = torch.tensor(tile)
            nr = len(tile)
            # 0. the input half of every layer's gate recompute, every s:
            # one product a layer, the bias added as a step reads it
            gxl = {0: gx0[:, b].view(steps, nr, 4, units)}
            for l in range(1, layers):
                prev = torch.stack([chain4[s - 1, l - 1, b] if s > 0 else
                                    torch.zeros(nr, out_dim)
                                    for s in range(steps)])
                gxl[l] = (prev @ wz[l, :out_dim]).view(steps, nr, 4, units) \
                    + case["bias"][l].view(4, units)
            carry = {l: (dcfin.view(layers, batch, units)[l, b].clone(),
                         dhfin.view(layers, batch, out_dim)[l, b].clone())
                     for l in range(layers)}
            sums = torch.zeros(layers, 7, units)
            published = [0] * layers   # the count every block of l published

            def bounds(ck):
                return (steps - 1 - ck * lag, max(0, steps - (ck + 1) * lag))

            def need(r, ck):
                # scheduler layer r is stack layer layers - 1 - r; its chunk
                # reads the din of the layer above at t + 1 for each of its
                # steps t (wait_blocks(above, steps - 1 - t) before step t)
                l = layers - 1 - r
                t_hi, t_lo = bounds(ck)
                if l == layers - 1 or t_lo + 1 >= steps:
                    return None
                return steps - 1 - t_lo

            def run(r, ck):
                l = layers - 1 - r
                t_hi, t_lo = bounds(ck)
                dc, dh = carry[l]
                for t in range(t_hi, t_lo - 1, -1):
                    if l + 1 < layers and t + 1 < steps:
                        assert published[l + 1] >= steps - 1 - t, \
                            "read before counted"
                    if l == layers - 1:
                        dchain = dout[t, b].clone()
                    elif t + 1 < steps:
                        dchain = seen[l + 1, t + 1, b].clone()
                    else:
                        dchain = torch.zeros(nr, out_dim)
                    if drop is not None:
                        dchain = dchain * drop[t, l, b]
                    m = mask[t, l, b][:, None]
                    h_prev = h4_all[t - 1, l, b] if t else hinit[l, b]
                    c_prev = c4[t - 1, l, b] if t else cinit[l, b]
                    dout_p = m * (dchain + dh)
                    dout_p_all[t, l, b] = dout_p
                    if l > 0:
                        din[l, t, b] = dchain if case["residual"][l] \
                            else torch.zeros_like(dchain)
                    partials = []
                    dg_rows = torch.zeros(nr, 4, units)
                    dc_next = dc.clone()
                    for q in range(cluster):
                        u = _units(q, us, units)
                        nu = len(u)
                        if nu == 0:
                            partials.append(torch.zeros(nr, out_dim))
                            continue
                        w = sl["wh_sl"][l, q, :out_dim, :, :nu]
                        g = gxl[l][t][..., u] + torch.einsum(
                            "rp,pkj->rkj", h_prev, w)
                        if proj is None:
                            dob = dout_p[:, u]
                        else:
                            dob = dout_p @ sl["proj_rows"][
                                l, q, :nu, :out_dim].t()
                        c0 = c_prev[:, u]
                        pi, pf, po = (peep[l, k, u] if peep is not None
                                      else 0.0 for k in range(3))
                        gi, gj, gf, go = g.unbind(1)
                        si, tj = torch.sigmoid(gi + pi * c0), torch.tanh(gj)
                        sf = torch.sigmoid(gf + pf * c0 + case["forget_bias"])
                        cn = sf * c0 + si * tj
                        so, tc = torch.sigmoid(go + po * cn), torch.tanh(cn)
                        d_o = dob * tc * so * (1 - so)
                        dcn = dob * so * (1 - tc * tc) + m * dc[:, u] \
                            + d_o * po
                        d_f = dcn * c0 * sf * (1 - sf)
                        d_i = dcn * tj * si * (1 - si)
                        d_j = dcn * si * (1 - tj * tj)
                        dc_next[:, u] = dcn * sf + (1 - m) * dc[:, u] \
                            + d_f * pf + d_i * pi
                        dg = torch.stack([d_i, d_j, d_f, d_o], 1)
                        dg_rows[:, :, u] = dg
                        c_new_all[t, l, b[:, None], u] = cn
                        out_blk[t, l, b[:, None], u] = so * tc
                        sums[l, :4, u] += dg.sum(0)
                        sums[l, 4, u] += (d_i * c0).sum(0)
                        sums[l, 5, u] += (d_f * c0).sum(0)
                        sums[l, 6, u] += (d_o * cn).sum(0)
                        partials.append(torch.einsum("rkj,pkj->rp", dg, w))
                    dgates[t, l, b] = dg_rows.reshape(nr, h4)
                    total = partials[0]
                    for part in partials[1:]:            # block order
                        total = total + part
                    dh = (1 - m) * dh + total
                    dc = dc_next
                carry[l] = (dc, dh)
                if l == 0:
                    return []
                # the chunk's din, block by block over its P-slice
                ts = torch.arange(t_lo, t_hi + 1)
                dg = dgates[ts, l][:, b].reshape(-1, h4)
                for q in range(cluster):
                    p = p_slice(q)
                    if len(p):
                        add = dg @ wz[l, p].t()
                        din[l, ts[:, None, None], b[None, :, None], p] += \
                            add.view(len(ts), nr, len(p))
                return [(q, p_slice(q), steps - t_lo) for q in range(cluster)]

            def publish(r, ck, q, cols):
                l = layers - 1 - r
                t_hi, t_lo = bounds(ck)
                idx = (l, slice(t_lo, t_hi + 1), b[:, None], cols[None, :])
                seen[idx] = din[idx]

            pipe = Pipeline(layers, chunks, cluster, order)
            real_publish = publish

            def counted_publish(r, ck, q, cols):
                real_publish(r, ck, q, cols)
                done[r][q] = steps - bounds(ck)[1]
                published[layers - 1 - r] = min(done[r])

            done = [[0] * cluster for _ in range(layers)]
            pipe.drive(need, run, counted_publish,
                       lambda r: r - 1 if r > 0 else None)
            for l in range(layers):
                dcinit[l, b], dhinit[l, b] = carry[l]
            col_parts.append(sums)
    cols = col_parts[0]
    for part in col_parts[1:]:                                # tile order
        cols = cols + part
    z = torch.cat([sk._inputs_before(chain, layers),
                   sk._previous(h_all, case["hinit"], layers)], dim=-1)
    dwz, _, dproj, _ = sk._weight_grads(
        z, dgates, sk._previous(c_all, case["cinit"], layers), None,
        None if proj is None else out_blk, dout_p_all, torch.float32)
    dpeep = None if peep is None else cols[:, 4:]
    return (dgates.reshape(steps, lb, h4), dwz, cols[:, :4].reshape(layers, h4),
            dproj, dpeep, dcinit.reshape(lb, units), dhinit.reshape(lb, out_dim),
            din)


def close(got, want, msg):
    np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=msg, **TOL)


CASES = [  # (rows, lag, per_wave, case overrides)
    (2, 1, 2, dict()),
    (2, 16, 1, dict(keep=0.9)),
    (3, 100, 2, dict(proj=None, residual=False, peepholes=False)),
    (4, 4, 1, dict(init=True, batch=7)),
    (3, 3, 3, dict(keep=0.9, init=True, proj=None)),
    (2, 5, 2, dict(batch=3, residual=False)),
]
# 16 blocks: every block owns units (US = 8) and, with the projection of
# 200, twelve own all of their 16 columns, one 8 and three none
WIDE = dict(units=128, proj=200)
WIDE_CASES = [  # (rows, lag, per_wave, case overrides, order)
    (2, 4, 1, dict(WIDE, keep=0.9, init=True, batch=3), "wavefront"),
    (3, 3, 2, dict(WIDE, batch=5, time_steps=9), "random0"),
    (2, 2, 1, dict(WIDE, proj=None, keep=0.9, batch=3, time_steps=9),
     "random1"),
    (2, 5, 2, dict(WIDE, init=True, batch=4, time_steps=10,
                   residual=False), "lazy"),
]
ORDERS = ["wavefront", "random0", "random1", "lazy"]


@pytest.mark.parametrize("rows,lag,per_wave,over", CASES)
def test_forward_partition_matches_plain(rows, lag, per_wave, over):
    case = make_case(1, **over)
    want = sk.stack_forward_reference(**case)
    got = pipeline_forward(case, rows, lag, per_wave)
    for name, g, w in zip(("out", "chain", "c_all", "h_all", "cfin", "hfin"),
                          got, want):
        close(g, w, name)


@pytest.mark.parametrize("rows,lag,per_wave,over,order", WIDE_CASES)
def test_forward_partition_16_blocks_matches_plain(rows, lag, per_wave, over,
                                                   order):
    """16 blocks a cluster, the layers' chunks and publishes interleaved."""
    case = make_case(5, dim=10, layers=3, **over)
    want = sk.stack_forward_reference(**case)
    got = pipeline_forward(case, rows, lag, per_wave, cluster=16,
                           order=order)
    for name, g, w in zip(("out", "chain", "c_all", "h_all", "cfin", "hfin"),
                          got, want):
        close(g, w, name)


@pytest.mark.parametrize("order", ORDERS[1:])
def test_forward_partition_under_interleaved_schedules(order):
    case = make_case(6, keep=0.9, init=True, batch=4)
    want = sk.stack_forward_reference(**case)
    got = pipeline_forward(case, 2, 2, 2, order=order)
    for name, g, w in zip(("out", "chain", "c_all", "h_all", "cfin", "hfin"),
                          got, want):
        close(g, w, name)


@pytest.mark.parametrize("lag", [1, 16, 100])
def test_forward_partition_with_the_affine(lag):
    case = make_case(2, affine=True, init=True)
    want = sk.stack_forward_reference(**case)
    got = pipeline_forward(case, 2, lag, 2)
    for name, g, w in zip(("out", "chain", "c_all", "h_all", "cfin", "hfin"),
                          got, want):
        close(g, w, name)


def test_a_wait_on_half_the_blocks_is_caught():
    """The emulation's hand-offs are block by block: a layer that waits for
    only 8 of the 16 blocks of the layer below (here the last 8, which the
    lazy order publishes first) reads chain columns not yet published, and
    its outputs leave the plain version's."""
    case = make_case(7, dim=10, layers=3, **dict(WIDE, batch=3,
                                                 time_steps=6))
    want = sk.stack_forward_reference(**case)
    got = pipeline_forward(case, 3, 2, 1, cluster=16, order="lazy")
    close(got[0], want[0], "out")
    got = pipeline_forward(case, 3, 2, 1, cluster=16, order="lazy",
                           watched=range(8, 16))
    assert not np.allclose(got[0].numpy(), want[0].numpy(), **TOL)


def _backward_case(seed, over):
    case = make_case(seed, **over)
    case.pop("affine")
    fwd = sk.stack_forward_reference(**case)
    out, chain, c_all, h_all, cfin, hfin = fwd
    rng = np.random.RandomState(seed + 1)
    dout = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    dcfin = torch.from_numpy(rng.randn(*cfin.shape).astype(np.float32))
    dhfin = torch.from_numpy(rng.randn(*hfin.shape).astype(np.float32))
    want = sk.stack_backward_reference(
        **case, chain=chain, c_all=c_all, h_all=h_all, dout=dout,
        dcfin=dcfin, dhfin=dhfin, steps_out=True)
    return case, fwd, (dout, dcfin, dhfin), want


def _check_backward(got, want):
    names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit", "dhinit")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        close(g, w, name)
    close(got[7][1:], want[9][1:], "din")


@pytest.mark.parametrize("rows,lag,per_wave,over", CASES)
def test_backward_partition_matches_plain(rows, lag, per_wave, over):
    case, fwd, cots, want = _backward_case(3, over)
    got = pipeline_backward(case, fwd, *cots, rows, lag, per_wave)
    _check_backward(got, want)


@pytest.mark.parametrize("rows,lag,per_wave,over,order", WIDE_CASES)
def test_backward_partition_16_blocks_matches_plain(rows, lag, per_wave, over,
                                                    order):
    """16 blocks a cluster: dh_prev the sum of 16 partials in block order,
    din by 16 P-slices; the layers' chunks and publishes interleaved."""
    case, fwd, cots, want = _backward_case(8, dict(over, dim=10, layers=3))
    got = pipeline_backward(case, fwd, *cots, rows, lag, per_wave,
                            cluster=16, order=order)
    _check_backward(got, want)


@pytest.mark.parametrize("order", ORDERS[1:])
def test_backward_partition_under_interleaved_schedules(order):
    case, fwd, cots, want = _backward_case(9, dict(keep=0.9, init=True,
                                                   batch=4))
    got = pipeline_backward(case, fwd, *cots, 2, 2, 2, order=order)
    _check_backward(got, want)
