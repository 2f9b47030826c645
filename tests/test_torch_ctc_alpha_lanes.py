"""K10's lane layout (``csrc/ctc_dp.cu`` ``ctc_alpha_kernel``), emulated on
the CPU.

The kernel runs one block per lattice row and a warp for every 32
positions (up to 16 warps): lane l of warp w holds positions 32·w·P + l +
32·j (j < P) in registers; a step's neighbours s - 1 and s - 2 come by one
shuffle each from the lanes before, and for lanes 0 and 1 from the last
lanes of the register before, with the registers updated from the last
down so that every shuffle sees the old row; the two positions before a
warp's range come from the warp before through shared memory (two
buffers, taken in turn by the live steps); lp(t) comes from a ring of 8
steps, time_mask as one ballot word per 32 steps loaded a word ahead,
valid and can_skip as bit masks.  Here that data movement is emulated
lane by lane (an overwritten register reads NaN until the step ends, so a
shuffle that saw a new value would show), and the log-sum-exp is the
plain version's own, on the same [N, S] layout, so the result is held
**bit-equal** to ``ctc_kernels.alpha_reference``, on widths that end inside,
at and past a register's 32 lanes, with valid, can_skip and time_mask
patterns that cross lane, warp and word boundaries; once with the
kernel's warps a row and once with a single warp a row (every boundary
then a register boundary).
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.ops import ctc_kernels

NEG = ctc_kernels.NEG_INF
LANES = 32
RING = 8
MAX_WARPS = 16
WIDTHS = [1, 2, 31, 32, 33, 64, 301, 1024]


def lattice_inputs(width, slots=3, steps=70, seed=0):
    """Arbitrary lattice inputs: log-probabilities, a time mask with gaps
    (not only a prefix) across 32-step words, random valid and can_skip
    bits, and alpha0 finite at a few positions."""
    rng = np.random.RandomState(seed + width)
    lp = np.log(rng.rand(steps, slots, width).astype(np.float32) + 1e-3)
    time_mask = rng.rand(steps, slots) < 0.85
    time_mask[:, 0] = np.arange(steps) < steps - 3        # a plain prefix
    valid = rng.rand(slots, width) < 0.9
    can_skip = rng.rand(slots, width) < 0.5
    can_skip[:, :2] = False
    alpha0 = np.full((slots, width), NEG, np.float32)
    alpha0[:, 0] = lp[0, :, 0]
    if width > 1:
        alpha0[:, 1] = lp[0, :, 1]
    alpha0[:, width // 2] = -2.0                          # deep in the row
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(lp), t(time_mask), t(valid), t(can_skip),
            t(alpha0.astype(np.float32)))


def row_warps(width):
    """The kernel's warps a row: one for every 32 positions, up to 16."""
    return min(MAX_WARPS, -(-width // LANES))


def lanes_alpha(lp_ext, time_mask, valid, can_skip, alpha0, warps=None):
    """alpha at every step [T, N, S], by the kernel's data movement:
    ``warps`` warps a row (the kernel's choice if None), warp w holding
    positions w·32·P + l + 32·j."""
    steps, slots, width = lp_ext.shape
    warps = warps or row_warps(width)
    per = -(-width // (LANES * warps))
    lane = torch.arange(LANES)
    pos = (torch.arange(warps)[:, None, None] * LANES * per
           + lane[None, :, None] + LANES * torch.arange(per)[None, None, :])
    inside = pos < width                          # [W, 32, P]

    def to_regs(row, fill):                       # [N, S] -> [N, W, 32, P]
        regs = torch.full((slots, warps, LANES, per), fill, dtype=row.dtype)
        regs[:, inside] = row[:, pos[inside]]
        return regs

    def to_row(regs):                             # [N, W, 32, P] -> [N, S]
        row = torch.empty(slots, width, dtype=regs.dtype)
        row[:, pos[inside]] = regs[:, inside]
        return row

    a = to_regs(alpha0, NEG)
    ok = to_regs(valid, False)
    skip = to_regs(can_skip & (torch.arange(width) >= 2), False)
    out = torch.empty(steps, slots, width)
    out[0] = to_row(a)

    ring = [None] * RING
    ring_step = [-1] * RING

    def fetch(t):
        if t < steps:
            ring[t % RING] = to_regs(lp_ext[t], 0.0)
            ring_step[t % RING] = t

    for t in range(1, RING):
        fetch(t)

    def mask_word(t0):                            # lane i: step t0 + i
        bits = torch.zeros(slots, dtype=torch.int64)
        for i in range(LANES):
            if t0 + i < steps:
                bits |= time_mask[t0 + i].long() << i
        return bits

    live, live_next = mask_word(0), mask_word(32)
    edges = [torch.full((slots, warps, 2), NEG) for _ in range(2)]
    turn = 0
    for t in range(1, steps):
        if t % 32 == 0:
            live, live_next = live_next, mask_word(t + 32)
        assert ring_step[t % RING] == t
        lpt = ring[t % RING]
        # each warp writes its last register's lanes 30, 31 (old values)
        # into this live step's buffer; after the row's barrier, lanes 30
        # and 31 of warp w read warp w - 1's
        edges[turn] = a[:, :, 30:, per - 1].clone()
        edge = torch.full((slots, warps, LANES), NEG)
        edge[:, 1:, 30:] = edges[turn][:, :-1]
        work = a.clone()
        b = torch.empty_like(a)
        c = torch.empty_like(a)
        for j in range(per - 1, -1, -1):
            prev = work[..., j - 1] if j > 0 else edge
            # each lane supplies what its reader needs: lane 31 (for lane 0)
            # and lanes 30, 31 (for lanes 0, 1) the register before
            b[..., j] = torch.where(lane == 31, prev, work[..., j])[
                ..., (lane + 31) % LANES]
            c[..., j] = torch.where(lane >= 30, prev, work[..., j])[
                ..., (lane + 30) % LANES]
            work[..., j] = float("nan")           # register j is rewritten
        c = torch.where(skip, c, torch.full_like(c, NEG))
        # the plain version's arithmetic, on its own [N, S] layout
        a_row, b_row, c_row = to_row(a), to_row(b), to_row(c)
        neg_row = torch.full_like(a_row, NEG)
        summed = ctc_kernels._log3sum(a_row, b_row, c_row)
        new = to_regs(torch.where(to_row(ok), summed + to_row(lpt),
                                  neg_row), NEG)
        is_live = ((live >> (t % 32)) & 1).bool()[:, None, None, None]
        a = torch.where(is_live, new, a)
        if is_live.any():
            turn ^= 1
        fetch(t + RING - 1)
        out[t] = to_row(a)
    return out


@pytest.mark.parametrize("warps", [1, None], ids=["one_warp", "kernel"])
@pytest.mark.parametrize("width", WIDTHS)
def test_lane_layout_is_bit_equal_to_plain(width, warps):
    args = lattice_inputs(width)
    got = lanes_alpha(*args, warps=warps)
    want = ctc_kernels.alpha_reference(*args)
    assert torch.equal(got, want)
    assert (got > NEG * 0.5).any()


def test_an_ascending_update_would_be_seen():
    """Updating the registers from the first up hands lane 0 the new value
    of position s - 1: the emulation's NaN shows it."""
    args = lattice_inputs(64)
    steps, slots, width = args[0].shape
    lane = torch.arange(LANES)
    a = torch.zeros(slots, LANES, 2)
    work = a.clone()
    work[:, :, 0] = float("nan")                  # register 0 rewritten first
    b = torch.where(lane == 31, work[:, :, 0], work[:, :, 1])[
        :, (lane + 31) % LANES]
    assert torch.isnan(b[:, 0]).all() and not torch.isnan(b[:, 1:]).any()
