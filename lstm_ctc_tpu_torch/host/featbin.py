"""Shared helpers for the featbin-equivalent CLI tools: the port's copy of
``lstm_ctc_tpu/featbin.py``, behind ``lstm_ctc_tpu_torch.bin``.

These tools natively replace the external Kaldi binaries the reference
pipes together (SURVEY §2.4: compute-fbank-feats, apply-cmvn, add-deltas,
splice-feats, subsample-feats, copy-feats, select-feats, copy-int-vector,
analyze-counts, feat-to-len, feat-to-dim), speaking the same ark/scp wire
formats so they interoperate with real Kaldi tools in either direction.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from . import logging_util as log
from .kaldi import Input


def parse_kaldi_flags(argv: List[str], spec: dict) -> Tuple[dict, List[str]]:
    """Kaldi-style ``--name=value`` flag parsing (also ``--name value``).

    spec: name → (type, default).  Returns (values, positional args).
    """
    values = {name: default for name, (_, default) in spec.items()}
    positional = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                name, raw = body.split("=", 1)
            else:
                name = body
                i += 1
                if i >= len(argv):
                    log.die("missing value for --%s" % name)
                raw = argv[i]
            name = name.replace("-", "_")
            if name not in spec:
                log.die("unknown option --%s" % body.split("=")[0])
            typ = spec[name][0]
            if typ is bool:
                values[name] = raw.lower() in ("true", "t", "yes", "1")
            else:
                values[name] = typ(raw)
        else:
            positional.append(arg)
        i += 1
    return values, positional


def parse_column_ranges(spec: str) -> np.ndarray:
    """Kaldi select-feats ranges: "20-25,0-13,7" → index array."""
    indices: List[int] = []
    for part in spec.split(","):
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            indices.extend(range(int(lo), int(hi) + 1))
        else:
            indices.append(int(part))
    return np.asarray(indices, np.int64)


def read_wave(rxfilename: str) -> Tuple[np.ndarray, float]:
    """Read a RIFF WAV (PCM16/PCM8/float32) from any rxfilename (incl.
    pipes).  Returns (samples [n] float32 in Kaldi's ±32768 scale,
    sample_rate)."""
    inp = Input(rxfilename, read_header=False)
    stream = inp.stream()
    riff = stream.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise IOError("not a RIFF WAVE file: %r" % rxfilename)
    fmt = None
    data = None
    while True:
        header = stream.read(8)
        if len(header) < 8:
            break
        chunk_id, size = header[:4], struct.unpack("<I", header[4:8])[0]
        payload = stream.read(size + (size & 1))
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", payload[:16])
        elif chunk_id == b"data":
            data = payload[:size]
            break
    inp.close()
    if fmt is None or data is None:
        raise IOError("missing fmt/data chunk in %r" % rxfilename)
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        samples = np.frombuffer(data, "<i2").astype(np.float32)
    elif audio_format == 1 and bits == 8:
        samples = (np.frombuffer(data, np.uint8).astype(np.float32)
                   - 128.0) * 256.0
    elif audio_format == 3 and bits == 32:
        samples = np.frombuffer(data, "<f4").astype(np.float32) * 32768.0
    else:
        raise IOError("unsupported wav encoding format=%d bits=%d"
                      % (audio_format, bits))
    if channels > 1:
        samples = samples.reshape(-1, channels)[:, 0].copy()
    return samples, float(sample_rate)


def load_config_file(values: dict, spec: dict, path: str) -> None:
    """Apply a Kaldi --config file (``--name=value`` per line)."""
    with open(path) as fh:
        args = [line.strip() for line in fh
                if line.strip() and not line.strip().startswith("#")]
    parsed, extra = parse_kaldi_flags(args, spec)
    if extra:
        log.die("positional junk in config file %s: %s" % (path, extra))
    values.update({k: v for k, v in parsed.items()
                   if v != spec[k][1]})
