"""Fused MoE expert mix, forward and backward: the wrappers around
``csrc/moe_fwd.cu`` (K4, K5), ``csrc/moe_bwd.cu`` (K6, K8),
``csrc/moe_wgrad.cu`` (K9) and ``csrc/moe_bwd_wgrad.cu`` (K7).

Counterpart of ``lstm_ctc_tpu/ops/moe_pallas.py`` ``moe_mix_fused`` (:574)
and its custom VJP (``fused_fwd`` / ``fused_bwd`` :544-570).  The mix is

    out[n, v] = sum_e gate[n, e] * drop(tau * tanh(x[n] @ W_e + b_e))[v]

computed without writing the ``[N, E·V]`` expert logits to memory.  In
training the forward (K5) also keeps th = tanh(x·W + b) in the compute
dtype, and the backward reads it:

  * ``wgrad_mode="xla"`` (the default): K6 gives dx, dgate and dz; dw =
    x(cdt)ᵀ·dz is one ``torch`` product with float32 sums and db = Σ dz,
    as XLA computes them outside the Pallas kernel there;
  * ``wgrad_mode="twokernel"``: K8 gives dx and dgate, and K9 recomputes
    dz for dw and db: in bf16 once, into a scratch, then K7's second stage
    makes dw and db from it; in float32 one kernel, no dz written;
  * ``wgrad_mode="kernel"``: K7 gives dx, dgate, dw and db from one dz:
    in bf16 K6's body writes dz once to a scratch and the product engine
    (``csrc/wg_product.cuh``) makes dw from it; in float32 one kernel, no
    dz written.

The modes are the reference's ``LSTM_CTC_TPU_MOE_WGRAD`` values, chosen
here by ``moe_wgrad_mode`` in nnet.config.

Expert dropout uses the counter-based hash ``hash_uniform`` at global (row
n, column e·V + v), bit for bit the reference's, so masks agree across
packages and between the forward and the backward.  The training seed is
a one-element int32 tensor on the device, which the kernels read there.

On a CPU tensor a wrapper runs its plain version (``moe_mix_reference``,
``moe_stash_reference``, ``moe_backward_reference``,
``moe_backward_noemit_reference``, ``moe_wgrad_reference``,
``moe_backward_wgrad_reference``); on a CUDA tensor it launches its kernel
or raises.  K4, K5 and K6 take every V the reference's fused kernels take
(lcm(V, 128) <= 4096, its ``fused_eligible``) and every V <= 128; K7, K8
and K9 (the opt-in modes) V <= 128; the float32 bodies D <= 1024.
``models/moe.py`` asks ``mix_eligible`` first and runs the plain mix under
autograd past that, as the reference takes XLA's einsum where
``fused_eligible`` refuses.

The bf16 bodies of K4/K5 and K6/K8 read W as a packed image, the exact
shared-memory operand tiles of their warpgroup products (``fwd_pack``,
``bwd_pack``), made once per weight tensor (``cells.derived``: once per
model in serving, once per step in training, where the weights change).
K4 and K5 cut an expert's V columns into tiles of at most 128
(``fwd_tiles``), a grid dimension of their launch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _build
from ..models.cells import derived, matmul_f32
from .route import warn_once

_M32 = 0xFFFFFFFF
WGRAD_MODES = ("xla", "twokernel", "kernel")
MAX_V = 128       # an expert's targets, at most, of K7, K8 and K9
MAX_COLS = 4096   # lcm(V, 128), at most, of K4-K6 past V = 128
MAX_D = 1024      # input width, at most, of the float32 bodies (bf16: any)


def targets_eligible(v: int, wgrad_mode: str = "xla") -> bool:
    """Whether the kernels of ``wgrad_mode`` take ``v`` targets an expert:
    under ``"xla"`` (K4, K5, K6) every V <= 128 and every V whose lcm with
    128 is at most 4096 (the reference's ``fused_eligible``:
    ``expert_block_size(V) · V <= MAX_COLS_BLOCK``, moe_pallas.py:104-112);
    under ``"twokernel"`` (K8, K9) and ``"kernel"`` (K7) V <= 128."""
    if v <= MAX_V:
        return True
    return wgrad_mode == "xla" and v * 128 // math.gcd(v, 128) <= MAX_COLS


def mix_eligible(d: int, v: int, compute_dtype, wgrad_mode: str = "xla",
                 warn: bool = False) -> bool:
    """Whether the kernels of the expert mix take input width ``d`` and
    ``v`` targets an expert in ``compute_dtype``, under ``wgrad_mode``
    (K4 or K5 forward, and its backward: K6, K8 + K9 or K7):
    ``targets_eligible``, and D <= 1024 where a float32 body runs (every
    bf16 body takes any D).  With ``warn``, a refusal warns once per
    process for each reason."""
    if wgrad_mode not in WGRAD_MODES:
        raise ValueError("wgrad_mode must be one of %s, got %r"
                         % (WGRAD_MODES, wgrad_mode))
    if not targets_eligible(v, wgrad_mode):
        if warn and wgrad_mode == "xla":
            warn_once("moe targets", "moe: %d targets an expert are outside "
                      "the CUDA kernels' V <= %d or lcm(V, 128) <= %d; using "
                      "the plain mix under autograd." % (v, MAX_V, MAX_COLS))
        elif warn:
            warn_once("moe targets " + wgrad_mode, "moe: %d targets an "
                      "expert exceed the %d of moe_wgrad_mode = %s; using "
                      "the plain mix under autograd (moe_wgrad_mode = xla "
                      "takes V <= %d or lcm(V, 128) <= %d on the kernels)."
                      % (v, MAX_V, wgrad_mode, MAX_V, MAX_COLS))
        return False
    if d > MAX_D and compute_dtype != torch.bfloat16:
        if warn:
            warn_once("moe f32 width", "moe: an input width of %d exceeds the "
                      "float32 kernels' %d; using the plain mix under "
                      "autograd (bfloat16 takes any width)." % (d, MAX_D))
        return False
    return True


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 x in [0, 2**32), without overflowing
    int64 (torch has few uint32 ops)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_uniform(seed, row0: int, col0: int, nrows: int, ncols: int,
                 device="cpu") -> torch.Tensor:
    """Uniforms in [0, 1) from the murmur3 finalizer over (global row,
    global col, seed): ``moe_pallas.hash_uniform`` (:85-101) in int64
    arithmetic masked to 32 bits, bit for bit.  ``seed`` is an int or a
    one-element integer tensor (read where it lies, without a host wait)."""
    rows = torch.arange(row0, row0 + nrows, dtype=torch.int64,
                        device=device)[:, None] & _M32
    cols = torch.arange(col0, col0 + ncols, dtype=torch.int64,
                        device=device)[None, :] & _M32
    s = torch.as_tensor(seed).to(device=device, dtype=torch.int64)
    s = s.reshape(()) & _M32
    x = (_mul32(rows, 0x9E3779B1) + _mul32(cols, 0x85EBCA77)
         + _mul32(s, 0xC2B2AE3D)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 9).to(torch.float32) * (1.0 / (1 << 23))


# The wgmma widths (N) compiled into K4/K5 (csrc/moe_fwd.cu fwd_np): a
# V-tile's columns are padded to the first that holds them.
FWD_PACK_WIDTHS = (16, 32, 64, 72, 128)


def fwd_pack_width(v: int) -> int:
    """K4/K5's padded width of a V-tile of ``v`` <= 128 columns (csrc/
    moe_fwd.cu ``fwd_np``)."""
    for width in FWD_PACK_WIDTHS:
        if v <= width:
            return width
    raise ValueError("a V-tile holds at most 128 columns, got %d" % v)


def fwd_tiles(v: int):
    """K4/K5's V-tiles of an expert's ``v`` columns, as (first column,
    columns, padded width): tiles of 128, then the rest padded to
    ``fwd_pack_width`` (csrc/moe_fwd.cu ``launch_bf16``).  One tile for
    V <= 128."""
    full, rest = divmod(v, 128) if v > 128 else (0, v)
    tiles = [(128 * t, 128, 128) for t in range(full)]
    if rest:
        tiles.append((128 * full, rest, fwd_pack_width(rest)))
    return tiles


def bwd_pack_width(d: int) -> int:
    """K6/K8's product width NI for D (csrc/moe_bwd.cu ``bwd_ni``): a
    block computes 4·NI columns of dx."""
    return 64 if d <= 256 else 160


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of the kernels' operand tiles over the last two
    dims ``[rows (a multiple of 8), 64]``: the 16-byte unit j (8 bf16) of
    row r goes to unit j ^ (r % 8) (csrc/wgmma.cuh ``sw128_offset``).  Its
    own inverse."""
    *lead, rows, cols = t.shape
    if cols != 64 or rows % 8:
        raise ValueError("swizzle128 takes [rows (8k), 64] tiles, got %s"
                         % (tuple(t.shape),))
    r = torch.arange(8, device=t.device)
    units = t.reshape(*lead, rows // 8, 8, 8, 8)  # [.., group, r % 8, j, 8]
    return units[..., r[:, None], r[:, None] ^ r[None, :], :].reshape(t.shape)


def fwd_pack(w: torch.Tensor, num_experts: int) -> torch.Tensor:
    """W ``[D, E·V]`` as K4/K5's image ``[E, chunks · VP, 64]`` in w's
    dtype (the kernels take bf16; chunks = ceil(D / 64), VP the sum of the
    padded widths NP of ``fwd_tiles(V)``): per expert, per V-tile and per
    64-deep chunk c of D, the tile ``[NP, 64]`` of W_eᵀ, rows v of the tile
    and columns d = 64c .. 64c + 63, zero past V and D, swizzled; one bulk
    copy of NP·128 bytes a tile.  Tile (t, c) of expert e starts at row
    chunks · v0 + c · NP of the expert's, v0 the tile's first column."""
    d, cols = w.shape
    v = cols // num_experts
    chunks = -(-d // 64)
    e_v_d = w.reshape(d, num_experts, v).permute(1, 2, 0)     # [E, V, D]
    parts = []
    for v0, count, width in fwd_tiles(v):
        t = F.pad(e_v_d[:, v0:v0 + count],
                  (0, chunks * 64 - d, 0, width - count))
        t = t.reshape(num_experts, width, chunks, 64).transpose(1, 2)
        parts.append(t.reshape(num_experts, chunks * width, 64))
    return swizzle128(torch.cat(parts, 1).contiguous())


def bwd_pack(w: torch.Tensor, num_experts: int) -> torch.Tensor:
    """W ``[D, E·V]`` as K6/K8's image ``[slices, chunks, 4·NI, 64]`` in
    w's dtype (the kernels take bf16; NI = ``bwd_pack_width(D)``, chunks =
    ceil(E·V / 64)): tile (s, c) is rows d = 4·NI·s .. and columns k = 64c
    .. 64c + 63 of W (Wᵀ, K-major, across expert boundaries), zero past D
    and E·V, swizzled."""
    d, cols = w.shape
    rows = 4 * bwd_pack_width(d)
    slices, chunks = -(-d // rows), -(-cols // 64)
    t = F.pad(w, (0, chunks * 64 - cols, 0, slices * rows - d))
    t = t.reshape(slices, rows, chunks, 64).transpose(1, 2)
    return swizzle128(t.contiguous())


def _drop_factor(seed, n: int, cols: int, keep_prob: float, device):
    """``[n, cols]``: 1 / keep_prob where the hash keeps an element, else 0."""
    u = hash_uniform(seed if seed is not None else 0, 0, 0, n, cols, device)
    return (u < keep_prob).float() * (1.0 / keep_prob)


def moe_mix_reference(x, w_expert, b_expert, gate, num_experts: int,
                      moe_temperature: float, keep_prob: float = 1.0,
                      seed=None, compute_dtype=torch.float32):
    """Plain version of K4, hash dropout included.

    x ``[N, D]``, w_expert ``[D, E·V]``, b_expert ``[E·V]``, gate ``[N, E]``
    (softmaxed) → ``[N, V]`` float32.  The expert product rounds its
    operands to ``compute_dtype`` and sums in float32, as the kernel does."""
    n = x.shape[0]
    v = w_expert.shape[1] // num_experts
    z = matmul_f32(x, w_expert, compute_dtype) + b_expert.float()
    a = moe_temperature * torch.tanh(z)                         # [N, E·V]
    if keep_prob < 1.0:
        a = a * _drop_factor(seed, n, num_experts * v, keep_prob, x.device)
    return torch.einsum("ne,nev->nv", gate.float(),
                        a.view(n, num_experts, v))


def _check(x, d: int, cols: int, num_experts: int, keep_prob: float,
           what: str, tensors=(), any_d: bool = False, mode: str = "xla"):
    """The limits the kernels take (x's device, D, E·V); returns V.  V as
    ``targets_eligible`` under ``mode``, the mode whose kernels these are
    (K4-K6: ``"xla"``); the bf16 bodies take any D (``any_d``), the float32
    ones D <= 1024 (``mix_eligible``)."""
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    v = cols // num_experts
    if v * num_experts != cols:
        raise ValueError("%s: %d columns do not split into %d experts"
                         % (what, cols, num_experts))
    if not targets_eligible(v, mode) or (d > MAX_D and not any_d):
        raise ValueError("%s: the kernel takes V <= %d%s and D <= %d, got "
                         "V=%d D=%d" % (what, MAX_V, " or lcm(V, 128) <= %d"
                                        % MAX_COLS if mode == "xla" else "",
                                        MAX_D, v, d))
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError("keep_prob must be in (0, 1]")
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError("%s: tensors on different devices" % what)
    return v


def _expect(t, shape, dtype, name, what):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError("%s: %s must be a contiguous %s %s, got %s %s"
                         % (what, name, dtype, tuple(shape), t.dtype,
                            tuple(t.shape)))


def _seed_ptr(seed, keep_prob: float, device):
    """The device seed's address (None when nothing is dropped)."""
    if keep_prob >= 1.0:
        return None
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32
            or seed.numel() != 1 or seed.device != device):
        raise ValueError("the training kernels take the dropout seed as an "
                         "int32 tensor of one element on %s" % device)
    return seed.data_ptr()


def _compute_dtype_of(w):
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % w.dtype)
    return w.dtype


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def moe_mix_forward(x, w_expert, b_expert, gate, num_experts: int,
                    moe_temperature: float, keep_prob: float = 1.0,
                    seed=None, compute_dtype=torch.bfloat16):
    """K4: mixed logits ``[N, V]``, no stash (serving and evaluation).

    Same arguments as ``moe_mix_reference``; ``seed`` (an int in int32 or
    uint32 range, or a one-element tensor) drives the expert dropout when
    keep_prob < 1."""
    if x.device.type == "cpu":
        return moe_mix_reference(x, w_expert, b_expert, gate, num_experts,
                                 moe_temperature, keep_prob, seed,
                                 compute_dtype)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % compute_dtype)
    n, d = x.shape
    v = _check(x, w_expert.shape[0], w_expert.shape[1], num_experts,
               keep_prob, "moe_mix_forward", (w_expert, b_expert, gate),
               any_d=compute_dtype == torch.bfloat16)
    if (w_expert.shape[0] != d or b_expert.shape != (num_experts * v,)
            or gate.shape != (n, num_experts)):
        raise ValueError("moe_mix_forward: inconsistent shapes x %s w %s b "
                         "%s gate %s" % (tuple(x.shape),
                                         tuple(w_expert.shape),
                                         tuple(b_expert.shape),
                                         tuple(gate.shape)))
    xc = x.float().contiguous()
    if compute_dtype == torch.bfloat16:
        w = derived([w_expert], ("fwd pack", num_experts),
                    lambda: fwd_pack(w_expert.to(torch.bfloat16), num_experts))
    else:
        w = derived([w_expert], ("expert weights", compute_dtype),
                    lambda: w_expert.to(compute_dtype, copy=True).contiguous())
    b = b_expert.float().contiguous()
    g = gate.float().contiguous()
    out = torch.empty(n, v, device=x.device)
    lib = _build.library()
    launch = lib.moe_fwd_bf16 if compute_dtype == torch.bfloat16 \
        else lib.moe_fwd_f32
    err = launch(x.device.index or 0, xc.data_ptr(), w.data_ptr(),
                 b.data_ptr(), g.data_ptr(), n, d, num_experts, v,
                 float(moe_temperature), float(keep_prob),
                 int(seed if seed is not None else 0) & _M32,
                 out.data_ptr(), _stream(x.device))
    _build.check(err, "moe_fwd")
    moe_mix_forward.launches += 1
    return out


moe_mix_forward.launches = 0


def moe_stash_reference(x, w, b, gate, seed, num_experts: int, tau: float,
                        keep_prob: float):
    """Plain version of K5: (out ``[N, V]`` float32, th ``[N, E·V]`` in
    w's dtype, the compute dtype).  x ``[N, D]`` float32, w ``[D, E·V]``,
    b ``[E·V]`` and gate ``[N, E]`` float32, seed an int32 tensor of one
    element (None at keep_prob 1)."""
    n = x.shape[0]
    v = w.shape[1] // num_experts
    th = torch.tanh(matmul_f32(x, w, w.dtype) + b.float())
    a = tau * th
    if keep_prob < 1.0:
        a = a * _drop_factor(seed, n, num_experts * v, keep_prob, x.device)
    out = torch.einsum("ne,nev->nv", gate.float(), a.view(n, num_experts, v))
    return out, th.to(w.dtype)


def moe_mix_forward_stash(x, w, b, gate, seed, num_experts: int, tau: float,
                          keep_prob: float):
    """K5: ``moe_mix_forward``'s output plus the stash th; arguments and
    result as ``moe_stash_reference``."""
    if x.device.type == "cpu":
        return moe_stash_reference(x, w, b, gate, seed, num_experts, tau,
                                   keep_prob)
    what = "moe_mix_forward_stash"
    n, d = x.shape
    v = _check(x, d, w.shape[1], num_experts, keep_prob, what,
               (w, b, gate, seed), any_d=w.dtype == torch.bfloat16)
    cdt = _compute_dtype_of(w)
    _expect(x, (n, d), torch.float32, "x", what)
    _expect(w, (d, num_experts * v), cdt, "w", what)
    _expect(b, (num_experts * v,), torch.float32, "b", what)
    _expect(gate, (n, num_experts), torch.float32, "gate", what)
    out = torch.empty(n, v, device=x.device)
    th = torch.empty(n, num_experts * v, device=x.device, dtype=cdt)
    if cdt == torch.bfloat16:
        w = derived([w], ("fwd pack", num_experts),
                    lambda: fwd_pack(w, num_experts))
    lib = _build.library()
    launch = lib.moe_fwd_stash_bf16 if cdt == torch.bfloat16 \
        else lib.moe_fwd_stash_f32
    err = launch(x.device.index or 0, x.data_ptr(), w.data_ptr(),
                 b.data_ptr(), gate.data_ptr(),
                 _seed_ptr(seed, keep_prob, x.device), n, d, num_experts, v,
                 float(tau), float(keep_prob), out.data_ptr(), th.data_ptr(),
                 _stream(x.device))
    _build.check(err, "moe_fwd_stash")
    moe_mix_forward_stash.launches += 1
    return out, th


moe_mix_forward_stash.launches = 0


def _dz(th, gate, gout, seed, num_experts: int, tau: float,
        keep_prob: float):
    """float32 (dz ``[N, E, V]``, a ``[N, E, V]``) from the stash, as
    ``moe_pallas._dz_core`` (:222-243) computes them."""
    n = th.shape[0]
    v = gout.shape[1]
    t = th.float().view(n, num_experts, v)
    q = gout.float()[:, None, :]
    dz = gate.float()[:, :, None] * q * (tau * (1.0 - t * t))
    a = tau * t
    if keep_prob < 1.0:
        m = _drop_factor(seed, n, num_experts * v, keep_prob,
                         th.device).view(n, num_experts, v)
        dz = dz * m
        a = a * m
    return dz, a


def moe_backward_reference(th, w, gate, gout, seed, num_experts: int,
                           tau: float, keep_prob: float):
    """Plain version of K6: (dx ``[N, D]``, dgate ``[N, E]``, float32; dz
    ``[N, E·V]`` in the compute dtype).  th ``[N, E·V]`` and w ``[D, E·V]``
    in the compute dtype, gate ``[N, E]`` and gout ``[N, V]`` float32."""
    n = th.shape[0]
    dz, a = _dz(th, gate, gout, seed, num_experts, tau, keep_prob)
    dgate = (gout.float()[:, None, :] * a).sum(-1)
    dzc = dz.reshape(n, -1).to(w.dtype)
    return matmul_f32(dzc, w.t(), w.dtype), dgate, dzc


def moe_backward_noemit_reference(th, w, gate, gout, seed, num_experts: int,
                                  tau: float, keep_prob: float):
    """Plain version of K8: K6's (dx, dgate) without dz."""
    return moe_backward_reference(th, w, gate, gout, seed, num_experts, tau,
                                  keep_prob)[:2]


def moe_wgrad_reference(x, th, gate, gout, seed, num_experts: int,
                        tau: float, keep_prob: float):
    """Plain version of K9: (dw ``[D, E·V]``, db ``[E·V]``), float32, with
    dz recomputed from the stash: dw = x(cdt)ᵀ·dz(cdt), db = Σ dz (dz
    unrounded, ``moe_pallas._wgrad_kernel`` :303-309)."""
    n = th.shape[0]
    dz, _ = _dz(th, gate, gout, seed, num_experts, tau, keep_prob)
    dz = dz.reshape(n, -1)
    return matmul_f32(x.t(), dz, th.dtype), dz.sum(0)


def moe_backward_wgrad_reference(x, th, w, gate, gout, seed,
                                 num_experts: int, tau: float,
                                 keep_prob: float):
    """Plain version of K7: (dx, dgate) as K8 and (dw, db) as K9 from the
    same dz (``moe_pallas._bwd_kernel_wgrad`` :311-333: dw from dz rounded
    to the compute dtype, db from dz unrounded).  x ``[N, D]`` float32; the
    rest as ``moe_backward_reference``."""
    args = (seed, num_experts, tau, keep_prob)
    return (moe_backward_noemit_reference(th, w, gate, gout, *args)
            + moe_wgrad_reference(x, th, gate, gout, *args))


def _backward_launch(th, w, gate, gout, seed, num_experts, tau, keep_prob,
                     emit_dz: bool, what: str):
    n = th.shape[0]
    d = w.shape[0]
    v = _check(th, d, w.shape[1], num_experts, keep_prob, what,
               (w, gate, gout, seed), any_d=w.dtype == torch.bfloat16,
               mode="xla" if emit_dz else "twokernel")
    cdt = _compute_dtype_of(w)
    _expect(th, (n, num_experts * v), cdt, "th", what)
    _expect(w, (d, num_experts * v), cdt, "w", what)
    _expect(gate, (n, num_experts), torch.float32, "gate", what)
    _expect(gout, (n, v), torch.float32, "gout", what)
    dx = torch.empty(n, d, device=th.device)
    dgate = torch.empty(n, num_experts, device=th.device)
    dz = torch.empty_like(th) if emit_dz else None
    if cdt == torch.bfloat16:
        w = derived([w], ("bwd pack", num_experts),
                    lambda: bwd_pack(w, num_experts))
    lib = _build.library()
    launch = lib.moe_bwd_bf16 if cdt == torch.bfloat16 else lib.moe_bwd_f32
    err = launch(th.device.index or 0, th.data_ptr(), w.data_ptr(),
                 gate.data_ptr(), gout.data_ptr(),
                 _seed_ptr(seed, keep_prob, th.device), n, d, num_experts, v,
                 float(tau), float(keep_prob), dx.data_ptr(), dgate.data_ptr(),
                 None if dz is None else dz.data_ptr(), _stream(th.device))
    _build.check(err, what)
    return dx, dgate, dz


def moe_mix_backward(th, w, gate, gout, seed, num_experts: int, tau: float,
                     keep_prob: float):
    """K6: (dx, dgate, dz); arguments and result as
    ``moe_backward_reference``."""
    if th.device.type == "cpu":
        return moe_backward_reference(th, w, gate, gout, seed, num_experts,
                                      tau, keep_prob)
    result = _backward_launch(th, w, gate, gout, seed, num_experts, tau,
                              keep_prob, True, "moe_bwd")
    moe_mix_backward.launches += 1
    return result


moe_mix_backward.launches = 0


def moe_mix_backward_noemit(th, w, gate, gout, seed, num_experts: int,
                            tau: float, keep_prob: float):
    """K8: (dx, dgate), K6 without the dz stream."""
    if th.device.type == "cpu":
        return moe_backward_noemit_reference(th, w, gate, gout, seed,
                                             num_experts, tau, keep_prob)
    dx, dgate, _ = _backward_launch(th, w, gate, gout, seed, num_experts,
                                    tau, keep_prob, False, "moe_bwd_noemit")
    moe_mix_backward_noemit.launches += 1
    return dx, dgate


moe_mix_backward_noemit.launches = 0


def moe_mix_wgrad(x, th, gate, gout, seed, num_experts: int, tau: float,
                  keep_prob: float):
    """K9: (dw, db); arguments and result as ``moe_wgrad_reference``.
    bf16: dz made once into a scratch, then K7's second stage, so (dw, db)
    are K7's bit for bit; float32: one kernel."""
    if x.device.type == "cpu":
        return moe_wgrad_reference(x, th, gate, gout, seed, num_experts, tau,
                                   keep_prob)
    what = "moe_wgrad"
    n, d = x.shape
    cdt = _compute_dtype_of(th)
    cols = th.shape[1]
    bf16 = cdt == torch.bfloat16
    v = _check(x, d, cols, num_experts, keep_prob, what,
               (th, gate, gout, seed), any_d=bf16, mode="twokernel")
    _expect(x, (n, d), torch.float32, "x", what)
    _expect(th, (n, num_experts * v), cdt, "th", what)
    _expect(gate, (n, num_experts), torch.float32, "gate", what)
    _expect(gout, (n, v), torch.float32, "gout", what)
    dw = torch.empty(d, cols, device=x.device)
    db = torch.empty(cols, device=x.device)
    lib = _build.library()
    scratch = None
    if bf16:  # dz and db's partials, then K7's second stage: K7's plan
        floats = lib.moe_bwd_wgrad_scratch_floats(x.device.index or 0, n, d,
                                                  num_experts, v, 1)
        if floats < 0:
            raise RuntimeError("moe_wgrad: the device's SM count cannot be "
                               "read")
        scratch = torch.empty(floats, device=x.device)
    launch = lib.moe_wgrad_bf16 if bf16 else lib.moe_wgrad_f32
    err = launch(x.device.index or 0, x.data_ptr(), th.data_ptr(),
                 gate.data_ptr(), gout.data_ptr(),
                 _seed_ptr(seed, keep_prob, x.device), n, d, num_experts, v,
                 float(tau), float(keep_prob), dw.data_ptr(), db.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 _stream(x.device))
    _build.check(err, what)
    moe_mix_wgrad.launches += 1
    return dw, db


moe_mix_wgrad.launches = 0


def moe_mix_backward_wgrad(x, th, w, gate, gout, seed, num_experts: int,
                           tau: float, keep_prob: float):
    """K7: (dx, dgate, dw, db) in one call; arguments and result as
    ``moe_backward_wgrad_reference``.  bf16: K6's body (dx and dgate bit
    for bit K6's, dz once into a scratch, db's partials), then dw on the
    product engine; float32: one kernel."""
    if x.device.type == "cpu":
        return moe_backward_wgrad_reference(x, th, w, gate, gout, seed,
                                            num_experts, tau, keep_prob)
    what = "moe_bwd_wgrad"
    n, d = x.shape
    v = _check(x, d, w.shape[1], num_experts, keep_prob, what,
               (th, w, gate, gout, seed), any_d=w.dtype == torch.bfloat16,
               mode="kernel")
    cdt = _compute_dtype_of(w)
    cols = num_experts * v
    _expect(x, (n, d), torch.float32, "x", what)
    _expect(th, (n, cols), cdt, "th", what)
    _expect(w, (d, cols), cdt, "w", what)
    _expect(gate, (n, num_experts), torch.float32, "gate", what)
    _expect(gout, (n, v), torch.float32, "gout", what)
    lib = _build.library()
    dx = torch.empty(n, d, device=x.device)
    dgate = torch.empty(n, num_experts, device=x.device)
    dw = torch.empty(d, cols, device=x.device)
    db = torch.empty(cols, device=x.device)
    bf16 = cdt == torch.bfloat16
    floats = lib.moe_bwd_wgrad_scratch_floats(x.device.index or 0, n, d,
                                              num_experts, v, int(bf16))
    if floats < 0:
        raise RuntimeError("moe_bwd_wgrad: the device's SM count cannot be "
                           "read")
    scratch = torch.empty(floats, device=x.device)
    if bf16:  # the first stage is K6's body, which reads W's packed image
        w = derived([w], ("bwd pack", num_experts),
                    lambda: bwd_pack(w, num_experts))
    launch = lib.moe_bwd_wgrad_bf16 if cdt == torch.bfloat16 \
        else lib.moe_bwd_wgrad_f32
    err = launch(x.device.index or 0, x.data_ptr(), th.data_ptr(),
                 w.data_ptr(), gate.data_ptr(), gout.data_ptr(),
                 _seed_ptr(seed, keep_prob, x.device), n, d, num_experts, v,
                 float(tau), float(keep_prob), dx.data_ptr(), dgate.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), scratch.data_ptr(),
                 _stream(x.device))
    _build.check(err, what)
    moe_mix_backward_wgrad.launches += 1
    return dx, dgate, dw, db


moe_mix_backward_wgrad.launches = 0


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two tensors of one compute dtype with float32 sums and
    a float32 result (cuBLAS's bf16 product with a float32 output on the
    card; the products of the rounded operands in float32 elsewhere)."""
    if a.dtype == torch.bfloat16 and a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MoeMix(torch.autograd.Function):
    """The expert mix under autograd: K5 forward, then K6 and one product
    (``"xla"``), K8 and K9 (``"twokernel"``) or K7 (``"kernel"``)
    backward."""

    @staticmethod
    def forward(ctx, x, w_expert, b_expert, gate, seed, num_experts, tau,
                keep_prob, compute_dtype, wgrad_mode):
        xc = x.float().contiguous()
        w = w_expert.to(compute_dtype).contiguous()
        g = gate.float().contiguous()
        out, th = moe_mix_forward_stash(xc, w, b_expert.float().contiguous(),
                                        g, seed, num_experts, tau, keep_prob)
        ctx.save_for_backward(xc, w, g, seed, th)
        ctx.args = (num_experts, tau, keep_prob, wgrad_mode)
        return out

    @staticmethod
    def backward(ctx, gout):
        xc, w, g, seed, th = ctx.saved_tensors
        num_experts, tau, keep_prob, wgrad_mode = ctx.args
        gout = gout.float().contiguous()
        args = (seed, num_experts, tau, keep_prob)
        if wgrad_mode == "twokernel":
            dx, dgate = moe_mix_backward_noemit(th, w, g, gout, *args)
            dw, db = moe_mix_wgrad(xc, th, g, gout, *args)
        elif wgrad_mode == "kernel":
            dx, dgate, dw, db = moe_mix_backward_wgrad(xc, th, w, g, gout,
                                                       *args)
        else:
            dx, dgate, dz = moe_mix_backward(th, w, g, gout, *args)
            dw = product_f32(xc.to(w.dtype).t(), dz)
            db = dz.float().sum(0)
        return (dx, dw, db, dgate) + (None,) * 6


def moe_mix_fused(x, w_expert, b_expert, gate, num_experts: int,
                  moe_temperature: float, keep_prob: float = 1.0,
                  seed=None, compute_dtype=torch.bfloat16,
                  wgrad_mode: str = "xla"):
    """Mixed logits ``[N, V]`` through the expert-mix kernels.

    Same arguments as ``moe_mix_reference``.  When autograd records (grad
    enabled and an input requires grad) the mix is differentiable: K5
    forward, and the backward ``wgrad_mode`` names (one of
    ``WGRAD_MODES``); ``seed`` must then be an int32 tensor of one element
    on x's device (or None at keep_prob 1).  Otherwise K4 runs."""
    if wgrad_mode not in WGRAD_MODES:
        raise ValueError("wgrad_mode must be one of %s, got %r"
                         % (WGRAD_MODES, wgrad_mode))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_expert, b_expert, gate)):
        return _MoeMix.apply(x, w_expert, b_expert, gate,
                             seed if keep_prob < 1.0 else None, num_experts,
                             float(moe_temperature), float(keep_prob),
                             compute_dtype, wgrad_mode)
    return moe_mix_forward(x, w_expert, b_expert, gate, num_experts,
                           moe_temperature, keep_prob, seed, compute_dtype)
