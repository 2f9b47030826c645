"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

The sources are compiled at first use by ``nvcc``, one process per ``.cu``
file, all started together, and linked into one shared library with a
plain C interface, under ``lstm_ctc_tpu_torch/build/`` and named by a hash
of the sources and flags, so an unchanged tree reuses it.  Nothing
here runs at import time: this module is imported on machines without
``nvcc`` or a GPU, where only the plain PyTorch versions run.  A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return a cudaError_t as int)
SIGNATURES = {
    # device, gx, lengths, keep, wh slices, proj slices, peep, forget_bias,
    # T, B, H, P, out, c_all, h_all, states_bf16, cfin, hfin, stream
    "lstm_fwd_f32": [_I, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                     _P, _P, _P, _I, _P, _P, _P],
    "lstm_fwd_bf16": [_I, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                      _P, _P, _P, _I, _P, _P, _P],
    # lstm_fwd_bf16's, then the plan (1 resident, 2 streamed) and R
    "lstm_fwd_bf16_forced": [_I, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                             _I, _P, _P, _P, _I, _P, _P, _P, _I, _I],
    # device, gx, lengths, keep, c_all, h_all, wh slices, proj rows, peep,
    # forget_bias, dout, dcfin, dhfin, T, B, H, P, store_bf16, dgates,
    # out_blk and dout_p stashes, dc_in, dh_in, dwh, dproj, dpeep,
    # scratch, stream
    "lstm_bwd_f32": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] * 5
                    + [_P] * 10,
    "lstm_bwd_bf16": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] * 5
                     + [_P] * 10,
    # a buffer of int64 (or NULL) for the streamed K1's or K2's clock64
    # stamps of its phases (scripts/layer_stamps.py)
    "lstm_fwd_stamps": [_P],
    "lstm_bwd_stamps": [_P],
    # lstm_bwd_bf16's, then the plan (1 resident, 2 streamed) and R
    "lstm_bwd_bf16_forced": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] * 5
                            + [_P] * 10 + [_I, _I],
    # K2's arguments (dgates: scratch), then x, wx, D, dx, dwx, dbias
    "lstm_bwd_fold_f32": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] * 5
                         + [_P] * 10 + [_P, _P, _I, _P, _P, _P],
    "lstm_bwd_fold_bf16": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] * 5
                          + [_P] * 10 + [_P, _P, _I, _P, _P, _P],
    # device, lp_ext, time_mask, valid, can_skip, alpha0, T, N, S, out,
    # stream
    "ctc_alpha": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # device, lp_ext, time_mask, is_last, valid, skip_from, final_mask,
    # T, N, S, out, stream
    "ctc_beta": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # device, seed, gx0, mask, wx rows, wh slices, proj slices, bias, peep,
    # cinit, hinit, affine a, affine b, forget_bias, keep_prob, residual
    # bits, S, L, B, H, P, out, chain, c_all, h_all, states_bf16, cfin,
    # hfin, scratch, stream
    "lstm_stack_fwd_f32": [_I] + [_P] * 12 + [_F, _F] + [_I] * 6 + [_P] * 4
                          + [_I] + [_P] * 4,
    "lstm_stack_fwd_bf16": [_I] + [_P] * 12 + [_F, _F] + [_I] * 6 + [_P] * 4
                           + [_I] + [_P] * 4,
    # lstm_stack_fwd_bf16's, then the plan (1 resident, 2-4 streamed) and R
    "lstm_stack_fwd_bf16_forced": [_I] + [_P] * 12 + [_F, _F] + [_I] * 6
                                  + [_P] * 4 + [_I] + [_P] * 4 + [_I, _I],
    # device, seed, gx0, mask, chain, c_all, h_all, cinit, hinit, wz, wh
    # slices, proj rows, bias, peep, forget_bias, keep_prob,
    # residual bits, dout, dcfin, dhfin, S, L, B, H, P, store_bf16, dgates,
    # out_blk and dout_p stashes, dcinit, dhinit, din, dc_in, dh_in, dwz,
    # dproj, dcols, scratch, stream
    "lstm_stack_bwd_f32": [_I] + [_P] * 13 + [_F, _F, _I] + [_P] * 3
                          + [_I] * 6 + [_P] * 13,
    "lstm_stack_bwd_bf16": [_I] + [_P] * 13 + [_F, _F, _I] + [_P] * 3
                           + [_I] * 6 + [_P] * 13,
    # lstm_stack_bwd_bf16's, then the plan (1 resident, 2-4 streamed) and R
    "lstm_stack_bwd_bf16_forced": [_I] + [_P] * 13 + [_F, _F, _I] + [_P] * 3
                                  + [_I] * 6 + [_P] * 13 + [_I, _I],
    # device, x, w, b, gate, N, D, E, V, tau, keep_prob, seed, out, stream
    "moe_fwd_f32": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                    ctypes.c_uint32, _P, _P],
    "moe_fwd_bf16": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                     ctypes.c_uint32, _P, _P],
    # device, x, w, b, gate, seed, N, D, E, V, tau, keep_prob, out, th,
    # stream
    "moe_fwd_stash_f32": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 3,
    "moe_fwd_stash_bf16": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 3,
    # device, th, w, gate, gout, seed, N, D, E, V, tau, keep_prob, dx,
    # dgate, dz (NULL: no dz stream), stream
    "moe_bwd_f32": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 4,
    "moe_bwd_bf16": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 4,
    # device, x, th, gate, gout, seed, N, D, E, V, tau, keep_prob, dw, db,
    # scratch (bf16), stream
    "moe_wgrad_f32": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 4,
    "moe_wgrad_bf16": [_I] + [_P] * 5 + [_I] * 4 + [_F, _F] + [_P] * 4,
    # device, x, th, w (bf16: K6's packed image), gate, gout, seed, N, D,
    # E, V, tau, keep_prob, dx, dgate, dw, db, scratch, stream
    "moe_bwd_wgrad_f32": [_I] + [_P] * 6 + [_I] * 4 + [_F, _F] + [_P] * 6,
    "moe_bwd_wgrad_bf16": [_I] + [_P] * 6 + [_I] * 4 + [_F, _F] + [_P] * 6,
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if the library for these sources is missing.
    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills) when it ran."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "liblstm_ctc_kernels_%s.so" % _digest())
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": "(cached)"}
    cu = [p for p in sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(p) + ".o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-I", CSRC_DIR, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src, proc.returncode, out) for src, proc, out
                  in zip(cu, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                "%s (%d):\n%s" % f for f in failed))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s%s"
                               % (link.returncode, link.stdout, link.stderr))
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial
    return {"path": path, "seconds": time.perf_counter() - start,
            "log": "".join(logs)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    # H, P, has_proj, bf16 (K2: and store_bf16) -> the blocks a cluster of
    # the kernel's launch plan for the shape (8 or 16, resident or
    # streamed), 0 if it has none (host arithmetic only)
    lib.lstm_fwd_fits.argtypes = [_I] * 4
    lib.lstm_fwd_fits.restype = ctypes.c_int
    lib.lstm_bwd_fits.argtypes = [_I] * 5
    lib.lstm_bwd_fits.restype = ctypes.c_int
    # the same of K12 and (with store_bf16) K13, at any of their R
    # (negative for their streamed plans; the clusters the card holds at
    # once not counted)
    lib.lstm_stack_fwd_fits.argtypes = [_I] * 4
    lib.lstm_stack_fwd_fits.restype = ctypes.c_int
    lib.lstm_stack_bwd_fits.argtypes = [_I] * 5
    lib.lstm_stack_bwd_fits.restype = ctypes.c_int
    lib.lstm_bwd_scratch_floats.argtypes = [_I, _I, _I, _I]
    lib.lstm_bwd_scratch_floats.restype = ctypes.c_longlong
    # device, B, H, P, has_proj, bf16 -> blocks a cluster, rows a cluster,
    # clusters, clusters resident at once, bytes, streamed or not, weight
    # bytes a block held and streamed a step (K1's launch and K2's); then R
    # (the streamed plan at that R, 0: the launcher's choice)
    for name in ("lstm_fwd_config", "lstm_bwd_config"):
        fn = getattr(lib, name)
        fn.argtypes = [_I] * 6 + [ctypes.POINTER(_I)] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_I)] + [
            ctypes.POINTER(ctypes.c_longlong)] * 2 + [_I]
        fn.restype = ctypes.c_int
    # device, T, B, H, P, D, bf16, store_bf16
    lib.lstm_bwd_fold_scratch_floats.argtypes = [_I] * 8
    lib.lstm_bwd_fold_scratch_floats.restype = ctypes.c_longlong
    # device, S, L, B, H, P, has_proj, bf16 (K13: and store_bf16) ->
    # {blocks, rows, tiles, tiles a wave, waves, lag, bytes, clusters
    # resident at once, streamed or not, weight bytes a block held and
    # streamed a step} (rows 0: the L layers are not resident together),
    # scratch floats
    _LL = ctypes.POINTER(ctypes.c_longlong)
    lib.lstm_stack_fwd_config.argtypes = [_I] * 8 + [_LL, _LL]
    lib.lstm_stack_fwd_config.restype = ctypes.c_int
    lib.lstm_stack_bwd_config.argtypes = [_I] * 9 + [_LL, _LL]
    lib.lstm_stack_bwd_config.restype = ctypes.c_int
    # device, N, D, E, V, bf16
    lib.moe_bwd_wgrad_scratch_floats.argtypes = [_I] * 6
    lib.moe_bwd_wgrad_scratch_floats.restype = ctypes.c_longlong
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (refused launch etc.)."""
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, err, msg))
