"""Fused MoE expert mix forward: the wrapper around ``csrc/moe_fwd.cu``.

Counterpart of ``lstm_ctc_tpu/ops/moe_pallas.py`` ``moe_mix_fused`` (:574),
whose Pallas kernel ``_fwd_kernel`` (:212, body ``_fwd_body`` :189-210)
computes

    out[n, v] = sum_e gate[n, e] * drop(tau * tanh(x[n] @ W_e + b_e))[v]

without writing the ``[N, E·V]`` expert tile to memory.  Expert dropout
uses the counter-based hash ``hash_uniform`` at global (row n, column
e·V + v), bit for bit the reference's, so masks agree across packages.

On a CPU tensor the wrapper runs the plain version (``moe_mix_reference``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..models.cells import derived, matmul_f32

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 x in [0, 2**32), without overflowing
    int64 (torch has few uint32 ops)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_uniform(seed: int, row0: int, col0: int, nrows: int, ncols: int,
                 device="cpu") -> torch.Tensor:
    """Uniforms in [0, 1) from the murmur3 finalizer over (global row,
    global col, seed): ``moe_pallas.hash_uniform`` (:85-101) in int64
    arithmetic masked to 32 bits, bit for bit."""
    rows = torch.arange(row0, row0 + nrows, dtype=torch.int64,
                        device=device)[:, None] & _M32
    cols = torch.arange(col0, col0 + ncols, dtype=torch.int64,
                        device=device)[None, :] & _M32
    s = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)
    x = (_mul32(rows, 0x9E3779B1) + _mul32(cols, 0x85EBCA77)
         + _mul32(s, 0xC2B2AE3D)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 9).to(torch.float32) * (1.0 / (1 << 23))


def moe_mix_reference(x, w_expert, b_expert, gate, num_experts: int,
                      moe_temperature: float, keep_prob: float = 1.0,
                      seed=None, compute_dtype=torch.float32):
    """Plain version of the expert-mix kernel, hash dropout included.

    x ``[N, D]``, w_expert ``[D, E·V]``, b_expert ``[E·V]``, gate ``[N, E]``
    (softmaxed) → ``[N, V]`` float32.  The expert product rounds its
    operands to ``compute_dtype`` and sums in float32, as the kernel does."""
    n = x.shape[0]
    v = w_expert.shape[1] // num_experts
    z = matmul_f32(x, w_expert, compute_dtype) + b_expert.float()
    a = moe_temperature * torch.tanh(z)                         # [N, E·V]
    if keep_prob < 1.0:
        u = hash_uniform(seed or 0, 0, 0, n, num_experts * v, x.device)
        a = a * ((u < keep_prob).float() * (1.0 / keep_prob))
    return torch.einsum("ne,nev->nv", gate.float(),
                        a.view(n, num_experts, v))


def moe_mix_fused(x, w_expert, b_expert, gate, num_experts: int,
                  moe_temperature: float, keep_prob: float = 1.0,
                  seed=None, compute_dtype=torch.bfloat16):
    """Mixed logits ``[N, V]`` through the expert-mix kernel.

    Same arguments as ``moe_mix_reference``; ``seed`` (an int in int32 or
    uint32 range) drives the expert dropout when keep_prob < 1."""
    if x.device.type == "cpu":
        return moe_mix_reference(x, w_expert, b_expert, gate, num_experts,
                                 moe_temperature, keep_prob, seed,
                                 compute_dtype)
    if x.device.type != "cuda":
        raise ValueError("moe_mix_fused: unsupported device %s" % x.device)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s"
                         % compute_dtype)
    n, d = x.shape
    cols = w_expert.shape[1]
    v = cols // num_experts
    if (w_expert.shape[0] != d or v * num_experts != cols
            or b_expert.shape != (cols,) or gate.shape != (n, num_experts)):
        raise ValueError("moe_mix_fused: inconsistent shapes x %s w %s b %s "
                         "gate %s" % (tuple(x.shape), tuple(w_expert.shape),
                                      tuple(b_expert.shape),
                                      tuple(gate.shape)))
    if v > 128 or d > 1024:
        raise ValueError("moe_mix_fused: the kernel takes V <= 128 and "
                         "D <= 1024, got V=%d D=%d" % (v, d))
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError("keep_prob must be in (0, 1]")
    for t in (w_expert, b_expert, gate):
        if t.device != x.device:
            raise ValueError("moe_mix_fused: tensors on different devices")
    xc = x.float().contiguous()
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
                 int(seed or 0) & _M32, out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "moe_fwd")
    moe_mix_fused.launches += 1
    return out


moe_mix_fused.launches = 0
