"""K2's cluster partition (``csrc/lstm_bwd.cu``), on the CPU.

The kernel splits one BLSTM layer's backward over a cluster of 8 blocks
(16 where no 8-block plan fits, up to H = 1024) per (direction, tile of R
batch rows): block q owns hidden units [q·US,
(q+1)·US) and holds its slice of wh and its rows of proj
(``lstm_kernels._backward_slices``).  Here the slices are checked to
reassemble to the weights exactly, and a plain emulation of the partition
(the cell backward of each block's units from its own slices, dh_prev as the
sum of the blocks' partials in block order, the peephole sums as
per-row-tile partials added in order) is held to
``cells.dual_recurrence_backward`` at rtol = atol = 1e-5 in float32.
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's many small ops slow
    down when their thread pool shares busy cores (the suite's workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weights(seed, units, proj):
    gen = torch.Generator().manual_seed(seed)
    pair = [cells.init_lstm_cell(gen, 4, units, proj, True) for _ in range(2)]
    return cells.recurrent_weights(pair[0], pair[1], torch.float32)


@pytest.mark.parametrize("units,proj,cluster", [
    (320, 320, 8), (16, 8, 8), (16, None, 8), (320, 320, 16), (16, 8, 16),
    (1024, 256, 16), (512, 512, 16), (384, 384, 16), (1024, None, 16)],
    ids=["320-320", "16-8", "16-None", "320-320-16", "16-8-16",
         "1024-256-16", "512-512-16", "384-384-16", "1024-None-16"])
def test_backward_slices_reassemble_to_the_weights(units, proj, cluster):
    wh, pj, _ = weights(0, units, proj)
    wh_sl, rows = lstm_kernels._backward_slices(wh, pj, cluster)
    out_dim = wh.shape[1]
    us = wh_sl.shape[-1]
    p16 = -(-out_dim // 16) * 16
    assert us % 8 == 0 and cluster * us >= units
    assert wh_sl.shape == (2, cluster, p16, 4, us)
    # block q's slice holds all four gates of units [q·US, (q+1)·US)
    full = wh_sl.permute(0, 2, 3, 1, 4).reshape(2, p16, 4, cluster * us)
    assert torch.equal(full[:, :out_dim, :, :units],
                       wh.view(2, out_dim, 4, units))
    assert not full[:, out_dim:].any() and not full[..., units:].any()
    if pj is None:
        assert rows is None
        return
    u16 = -(-us // 16) * 16
    assert rows.shape == (2, cluster, u16, p16)
    assert torch.equal(rows[:, :, :us].reshape(2, cluster * us, p16)
                       [:, :units, :out_dim], pj)
    assert not rows[:, :, us:].any() and not rows[..., out_dim:].any()
    assert not rows[:, :, :us].reshape(2, cluster * us, p16)[:, units:].any()
    # the wh slices are K1's own (of its resident plans' layout), made once
    assert wh_sl is cells.derived([wh, pj], ("cluster slices", cluster,
                                             False), lambda: None)[0]


def cluster_backward(gx, seq, keep, wh, proj, peep, c_all, h_all, dout,
                     dcfin, dhfin, rows, cluster=8):
    """The kernel's partition with ``cluster`` blocks a cluster in plain
    torch (float32): (dgates, dh_in, dpeep)."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    out_dim = h_all.shape[2]
    wh_sl, pj_rows = lstm_kernels._backward_slices(wh, proj, cluster)
    us = wh_sl.shape[-1]
    dgates = torch.zeros(steps, b2, h4)
    dh_in = torch.zeros(steps, b2, out_dim)
    tiles = []
    for d in range(2):
        for b0 in range(0, batch, rows):
            br = torch.arange(b0, min(batch, b0 + rows))
            rr = d * batch + br
            dc = dcfin[rr].clone()
            dh = dhfin[rr].clone()
            sums = torch.zeros(3, units)
            for t in range(steps - 1, -1, -1):
                kp = keep[t, br][:, None] if keep is not None else 1.0
                m = (t < seq[br]).float()[:, None]
                h_prev = kp * h_all[t - 1, rr] if t else torch.zeros_like(dh)
                c_prev = kp * c_all[t - 1, rr] if t else torch.zeros_like(dc)
                dh_in[t, rr] = dh
                dout_p = m * (dout[t, rr] + dh)
                partials = []
                dg_rows = torch.zeros(len(br), 4, units)
                for q in range(cluster):
                    u = torch.arange(min(units, q * us), min(units, (q + 1) * us))
                    nu = len(u)
                    w = wh_sl[d, q, :out_dim, :, :nu]          # [P, 4, nu]
                    if nu == 0:
                        partials.append(torch.zeros_like(dh))
                        continue
                    gate = gx[t, rr].view(-1, 4, units)[:, :, u] + torch.einsum(
                        "rp,pkj->rkj", h_prev, w)
                    if proj is None:
                        dob = dout_p[:, u]
                    else:
                        dob = dout_p @ pj_rows[d, q, :nu, :out_dim].t()
                    c0 = c_prev[:, u]
                    pi, pf, po = (peep[d, k, u] if peep is not None else 0.0
                                  for k in range(3))
                    gi, gj, gf, go = gate.unbind(1)
                    si, tj = torch.sigmoid(gi + pi * c0), torch.tanh(gj)
                    sf = torch.sigmoid(gf + pf * c0 + FORGET_BIAS)
                    cn = sf * c0 + si * tj
                    so, tc = torch.sigmoid(go + po * cn), torch.tanh(cn)
                    d_o = dob * tc * so * (1 - so)
                    dcn = dob * so * (1 - tc * tc) + m * dc[:, u] + d_o * po
                    d_f = dcn * c0 * sf * (1 - sf)
                    d_i = dcn * tj * si * (1 - si)
                    d_j = dcn * si * (1 - tj * tj)
                    dc[:, u] = kp * (dcn * sf + (1 - m) * dc[:, u] + d_f * pf
                                     + d_i * pi)
                    dg = torch.stack([d_i, d_j, d_f, d_o], 1)  # [r, 4, nu]
                    dg_rows[:, :, u] = dg
                    sums[0, u] += (d_i * c0).sum(0)
                    sums[1, u] += (d_f * c0).sum(0)
                    sums[2, u] += (d_o * cn).sum(0)
                    # this block's partial dh_prev: dgates_q · wh_qᵀ
                    partials.append(torch.einsum("rkj,pkj->rp", dg, w))
                dgates[t, rr] = dg_rows.reshape(len(br), h4)
                total = partials[0]
                for part in partials[1:]:                  # block order
                    total = total + part
                dh = kp * ((1 - m) * dh + total)
            tiles.append((d, sums))
    dpeep = torch.zeros(2, 3, units)
    for d, sums in tiles:                                  # row tiles in order
        dpeep[d] += sums
    return dgates, dh_in, dpeep


def partition_case(batch, proj, reset, steps=11, units=16):
    """A layer's inputs, its plain forward's states and random cotangents,
    from a numpy seed."""
    rng = np.random.RandomState(batch + 10 * reset)
    wh, pj, peep = weights(batch, units, proj)
    out_dim = wh.shape[1]
    seq = torch.from_numpy(rng.randint(steps // 2, steps + 1, batch))
    seq[0] = steps
    reset_mask = None
    if reset:
        mask = np.zeros((batch, steps), np.float32)
        mask[:, 0] = 1.0
        for b in range(batch):
            mask[b, rng.randint(1, int(seq[b]), 2)] = 1.0
        reset_mask = torch.from_numpy(mask)
    _, keep = cells.step_masks(seq, reset_mask, steps, "cpu")
    gx = torch.from_numpy(rng.randn(steps, 2 * batch, 4 * units)
                          .astype(np.float32))
    _, _, _, c_all, h_all = cells.dual_recurrence(
        gx, seq, keep, wh, pj, peep, FORGET_BIAS, states=True)
    dout = torch.from_numpy(rng.randn(steps, 2 * batch, out_dim)
                            .astype(np.float32))
    dcfin = torch.from_numpy(rng.randn(2 * batch, units).astype(np.float32))
    dhfin = torch.from_numpy(rng.randn(2 * batch, out_dim).astype(np.float32))
    return (gx, seq, keep, wh, pj, peep, FORGET_BIAS, c_all, h_all, dout,
            dcfin, dhfin)


def check_partition(args, rows, cluster):
    dgates, _, _, dpeep, _, dh_in = cells.dual_recurrence_backward(
        *args, steps=True)
    gx, seq, keep, wh, pj, peep = args[:6]
    got = cluster_backward(gx, seq, keep, wh, pj, peep, *args[7:], rows,
                           cluster)
    np.testing.assert_allclose(got[0].numpy(), dgates.numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), dh_in.numpy(), **TOL)
    np.testing.assert_allclose(got[2].numpy(), dpeep.numpy(), **TOL)


@pytest.mark.parametrize("batch,proj,reset,cluster", [
    (4, 8, False, 8), (5, 8, True, 8), (5, None, False, 8),
    (3, None, True, 8), (7, 8, True, 8), (4, 8, False, 16),
    (5, 8, True, 16), (3, None, True, 16)],
    ids=["4-8-False", "5-8-True", "5-None-False", "3-None-True",
         "7-8-True", "4-8-False-16", "5-8-True-16", "3-None-True-16"])
def test_cluster_partition_matches_plain(batch, proj, reset, cluster):
    check_partition(partition_case(batch, proj, reset), 2, cluster)


@pytest.mark.parametrize("units,proj", [(1024, 256), (512, 512),
                                        (384, 384), (512, None)])
def test_wide_cluster_partition_matches_plain(units, proj):
    """The widths only 16 blocks take (64 units a block and PS = 16 dh
    columns at H = 1024, P = 256), R = 2 (H = P = 512's only R), two row
    tiles, T = 4, resets: dgates, the carried dh and the peephole sums as
    the plain backward's."""
    check_partition(partition_case(3, proj, True, steps=4, units=units), 2,
                    16)
