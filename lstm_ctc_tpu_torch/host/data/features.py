"""Feature extraction: Kaldi-algorithm fbank/MFCC, CMVN, deltas, splicing.

The port's copy of ``lstm_ctc_tpu/data/features.py`` (numpy only).

The reference delegates all featurization to external Kaldi C++ binaries
(``compute-fbank-feats``, ``apply-cmvn``, ``add-deltas``, … — SURVEY §2.4);
this module implements the same algorithms natively so the full recipe runs
without Kaldi.  These numpy paths back the featbin-equivalent CLI tools.

Algorithm parity with Kaldi (src/feat/feature-window.{h,cc},
feature-fbank.cc, mel-computations.cc):
  * frames of ``frame_length_ms`` every ``frame_shift_ms``; with
    ``snip_edges`` (default) the number of frames is
    1 + (num_samples - window) // shift;
  * optional dither, DC offset removal, preemphasis 0.97;
  * "povey" window ((0.5 - 0.5 cos)^0.85) by default;
  * FFT of the next power of two, power spectrum;
  * mel filterbank with bins spaced uniformly on the mel scale
    (1127 ln(1 + f/700)), triangular weights;
  * log of the energies floored at epsilon.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def feature_window(frame_length: int, window_type: str = "povey") -> np.ndarray:
    a = 2.0 * math.pi / (frame_length - 1)
    i = np.arange(frame_length, dtype=np.float64)
    if window_type == "hanning":
        return (0.5 - 0.5 * np.cos(a * i)).astype(np.float32)
    if window_type == "hamming":
        return (0.54 - 0.46 * np.cos(a * i)).astype(np.float32)
    if window_type == "povey":
        return ((0.5 - 0.5 * np.cos(a * i)) ** 0.85).astype(np.float32)
    if window_type == "rectangular":
        return np.ones(frame_length, np.float32)
    if window_type == "blackman":
        return (0.42 - 0.5 * np.cos(a * i)
                + 0.08 * np.cos(2 * a * i)).astype(np.float32)
    raise ValueError("unknown window type %r" % window_type)


def mel_filterbank(num_bins: int, fft_size: int, sample_freq: float,
                   low_freq: float = 20.0,
                   high_freq: float = 0.0) -> np.ndarray:
    """[num_bins, fft_size//2 + 1] triangular mel weights (Kaldi layout)."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_freqs = np.arange(fft_size // 2 + 1) * (sample_freq / fft_size)
    mel_freqs = mel_scale(fft_freqs)
    bank = np.zeros((num_bins, fft_size // 2 + 1), np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bank[b] = np.maximum(0.0, np.minimum(up, down))
    return bank


def extract_frames(wave: np.ndarray,
                   sample_freq: float = 16000.0,
                   frame_length_ms: float = 25.0,
                   frame_shift_ms: float = 10.0,
                   dither: float = 1.0,
                   preemph_coeff: float = 0.97,
                   remove_dc_offset: bool = True,
                   window_type: str = "povey",
                   snip_edges: bool = True,
                   seed: Optional[int] = None,
                   return_raw_energy: bool = False):
    """wave [num_samples] → windowed frames [num_frames, frame_length]
    (optionally plus the Kaldi raw_energy=true per-frame log energy —
    measured before preemphasis/windowing)."""
    wave = np.asarray(wave, np.float64)
    frame_length = int(sample_freq * frame_length_ms / 1000.0)
    frame_shift = int(sample_freq * frame_shift_ms / 1000.0)
    if snip_edges:
        if len(wave) < frame_length:
            return np.zeros((0, frame_length), np.float32)
        num_frames = 1 + (len(wave) - frame_length) // frame_shift
        indices = (np.arange(num_frames)[:, None] * frame_shift
                   + np.arange(frame_length)[None, :])
        frames = wave[indices]
    else:
        num_frames = (len(wave) + frame_shift // 2) // frame_shift
        frames = np.zeros((num_frames, frame_length), np.float64)
        for f in range(num_frames):
            start = f * frame_shift + frame_shift // 2 - frame_length // 2
            for j in range(frame_length):
                s = start + j
                # mirror at the edges (Kaldi's reflection)
                if s < 0:
                    s = -s - 1
                if s >= len(wave):
                    s = 2 * len(wave) - 1 - s
                frames[f, j] = wave[s]
    if dither != 0.0:
        rng = np.random.RandomState(seed)
        frames = frames + dither * rng.randn(*frames.shape)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    # Kaldi raw_energy=true measures energy HERE — after dither/DC
    # removal, before preemphasis and windowing
    raw_log_energy = np.log(np.maximum(
        (frames ** 2).sum(axis=1), np.finfo(np.float64).eps))
    if preemph_coeff != 0.0:
        pre = np.empty_like(frames)
        pre[:, 1:] = frames[:, 1:] - preemph_coeff * frames[:, :-1]
        pre[:, 0] = frames[:, 0] * (1.0 - preemph_coeff)
        frames = pre
    frames = frames * feature_window(frame_length, window_type)
    if return_raw_energy:
        return frames.astype(np.float32), raw_log_energy
    return frames.astype(np.float32)


def compute_fbank(wave: np.ndarray,
                  sample_freq: float = 16000.0,
                  num_mel_bins: int = 23,
                  frame_length_ms: float = 25.0,
                  frame_shift_ms: float = 10.0,
                  dither: float = 1.0,
                  preemph_coeff: float = 0.97,
                  window_type: str = "povey",
                  low_freq: float = 20.0,
                  high_freq: float = 0.0,
                  use_energy: bool = False,
                  raw_energy: bool = True,
                  use_log_fbank: bool = True,
                  snip_edges: bool = True,
                  seed: Optional[int] = None) -> np.ndarray:
    """→ [num_frames, num_mel_bins(+1 with energy)] log-mel features.
    ``raw_energy`` (Kaldi default true): energy measured before
    preemphasis/windowing; false = energy of the processed frame."""
    frames, pre_energy = extract_frames(
        wave, sample_freq, frame_length_ms, frame_shift_ms, dither,
        preemph_coeff, True, window_type, snip_edges, seed,
        return_raw_energy=True)
    if frames.shape[0] == 0:
        return np.zeros((0, num_mel_bins + (1 if use_energy else 0)),
                        np.float32)
    if use_energy:
        if raw_energy:
            log_energy = pre_energy
        else:
            log_energy = np.log(np.maximum(
                (frames.astype(np.float64) ** 2).sum(axis=1),
                np.finfo(np.float64).eps))
    fft_size = _next_pow2(frames.shape[1])
    spectrum = np.fft.rfft(frames, n=fft_size, axis=1)
    power = (spectrum.real ** 2 + spectrum.imag ** 2)
    bank = mel_filterbank(num_mel_bins, fft_size, sample_freq,
                          low_freq, high_freq)
    mel_energies = power @ bank.T
    if use_log_fbank:
        mel_energies = np.log(
            np.maximum(mel_energies, np.finfo(np.float32).eps))
    feats = mel_energies.astype(np.float32)
    if use_energy:
        feats = np.concatenate(
            [log_energy[:, None].astype(np.float32), feats], axis=1)
    return feats


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Type-II DCT matrix with Kaldi normalization."""
    m = np.zeros((num_ceps, num_bins), np.float64)
    m[0] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        m[k] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi * k * (np.arange(num_bins) + 0.5) / num_bins)
    return m.astype(np.float32)


def compute_mfcc(wave: np.ndarray,
                 sample_freq: float = 16000.0,
                 num_mel_bins: int = 23,
                 num_ceps: int = 13,
                 cepstral_lifter: float = 22.0,
                 use_energy: bool = True,
                 **kwargs) -> np.ndarray:
    """Kaldi compute-mfcc-feats semantics: the DCT runs over the mel
    bins only; with use_energy (the Kaldi default) C0 is REPLACED by the
    log energy (previously the energy column was fed into the DCT,
    which crashed on a shape mismatch)."""
    fbank = compute_fbank(wave, sample_freq=sample_freq,
                          num_mel_bins=num_mel_bins, use_log_fbank=True,
                          use_energy=use_energy, **kwargs)
    if fbank.shape[0] == 0:
        return np.zeros((0, num_ceps), np.float32)
    energy = None
    if use_energy:
        energy, fbank = fbank[:, 0], fbank[:, 1:]
    ceps = fbank @ dct_matrix(num_ceps, num_mel_bins).T
    if energy is not None:
        ceps[:, 0] = energy
    if cepstral_lifter != 0.0:
        k = np.arange(num_ceps)
        lifter = 1.0 + 0.5 * cepstral_lifter * np.sin(
            math.pi * k / cepstral_lifter)
        ceps = ceps * lifter.astype(np.float32)
    return ceps.astype(np.float32)


# ---------------------------------------------------------------------------
# CMVN (Kaldi compute-cmvn-stats / apply-cmvn)
# ---------------------------------------------------------------------------

def accumulate_cmvn_stats(feats: np.ndarray,
                          stats: Optional[np.ndarray] = None) -> np.ndarray:
    """Kaldi CMVN stats layout: [2, dim+1]; row 0 = (sum, count),
    row 1 = (sumsq, 0)."""
    dim = feats.shape[1]
    if stats is None:
        stats = np.zeros((2, dim + 1), np.float64)
    stats[0, :dim] += feats.sum(axis=0, dtype=np.float64)
    stats[0, dim] += feats.shape[0]
    stats[1, :dim] += (feats.astype(np.float64) ** 2).sum(axis=0)
    return stats


def apply_cmvn(feats: np.ndarray, stats: np.ndarray,
               norm_means: bool = True,
               norm_vars: bool = False) -> np.ndarray:
    dim = feats.shape[1]
    count = stats[0, dim]
    mean = stats[0, :dim] / count
    if norm_vars and not norm_means:
        raise ValueError(
            "cannot normalize variance without normalizing mean")
    out = np.asarray(feats, np.float32)
    if norm_means:
        out = out - mean.astype(np.float32)
    if norm_vars:
        var = stats[1, :dim] / count - mean ** 2
        scale = 1.0 / np.sqrt(np.maximum(var, 1e-20))
        out = out * scale.astype(np.float32)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Deltas (Kaldi add-deltas)
# ---------------------------------------------------------------------------

def delta_coefficients(order: int = 2, window: int = 2):
    """Per-order FIR filters exactly as Kaldi DeltaFeatures computes them."""
    scales = [np.asarray([1.0])]
    for _ in range(order):
        prev = scales[-1]
        denominator = sum(i * i for i in range(1, window + 1)) * 2.0
        cur = np.zeros(len(prev) + 2 * window)
        for offset in range(-window, window + 1):
            cur[offset + window:offset + window + len(prev)] += \
                (offset / denominator) * prev
        scales.append(cur)
    return scales


def add_deltas(feats: np.ndarray, order: int = 2,
               window: int = 2) -> np.ndarray:
    """[T, D] → [T, D*(order+1)] with edge-replicated context."""
    num_frames, dim = feats.shape
    if num_frames == 0:
        return np.zeros((0, dim * (order + 1)), np.float32)
    scales = delta_coefficients(order, window)
    out = np.zeros((num_frames, dim * (order + 1)), np.float32)
    padded = np.pad(feats, ((order * window, order * window), (0, 0)),
                    mode="edge")
    for o, coeffs in enumerate(scales):
        half = (len(coeffs) - 1) // 2
        acc = np.zeros((num_frames, dim), np.float64)
        for j, c in enumerate(coeffs):
            if c == 0.0:
                continue
            offset = j - half + order * window
            acc += c * padded[offset:offset + num_frames]
        out[:, o * dim:(o + 1) * dim] = acc
    return out
