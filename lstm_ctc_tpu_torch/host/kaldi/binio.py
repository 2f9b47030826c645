"""Kaldi binary/text object codecs (host-side I/O runtime).

Bit-compatible with Kaldi's C++ ``io_funcs`` / ``kaldi-matrix`` formats so
that unmodified Kaldi/EESEN binaries interoperate with this framework's
archives.  The reference toolkit ships a pure-Python reimplementation of the
same formats (reference pyKaldiIO/io_funcs.py, pyKaldiIO/kaldi_matrix.py);
this module covers the same wire formats with vectorized numpy codecs and
additionally implements what the reference lacks: text-mode matrix/vector
reading, double-precision objects, and compressed-matrix *writing*.

Wire formats (Kaldi spec):
  * A binary object stream starts with the two bytes ``\\x00B``.
  * A token is ASCII text terminated by a single space.
  * A "basic type" (int32/float/...) is a 1-byte size marker followed by the
    little-endian raw value.
  * Float matrix: token ``FM``, int32 rows, int32 cols, rows*cols float32.
  * Float vector: token ``FV``, int32 size, size float32.
  * Double variants use ``DM`` / ``DV`` with float64 payloads.
  * Compressed matrix: token ``CM`` (format 1, per-column uint16 percentile
    headers + uint8 codes, column-major), ``CM2`` (format 2, uint16 codes,
    row-major).
  * std::vector<int32> holder: int32 size then each element as a basic type
    (each with its own size marker).
  * Posterior: int32 #frames, then per frame int32 #pairs and (int32, float)
    pairs.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

BINARY_MAGIC = b"\x00B"


class KaldiIOError(IOError):
    pass


# ---------------------------------------------------------------------------
# Stream initialisation
# ---------------------------------------------------------------------------

def init_input_stream(stream) -> bool:
    """Consume the optional ``\\x00B`` header; return True if binary.

    ``stream`` is any object with ``peek(n)->bytes`` and ``read(n)->bytes``
    (see streams.InputStream).
    """
    first = stream.peek(1)
    if not first:
        raise KaldiIOError("end of stream while detecting binary header")
    if first == b"\x00":
        stream.read(1)
        second = stream.read(1)
        if second != b"B":
            raise KaldiIOError(
                "malformed binary header: \\x00 not followed by 'B'")
        return True
    return False


def init_output_stream(stream, binary: bool) -> None:
    if binary:
        stream.write(BINARY_MAGIC)


# ---------------------------------------------------------------------------
# Tokens and basic types
# ---------------------------------------------------------------------------

def read_token(stream, binary: bool, eat_trailing_space: bool = True) -> str:
    out = bytearray()
    if not binary:
        while True:
            c = stream.peek(1)
            if c in (b" ", b"\n", b"\t", b"\r"):
                stream.read(1)
            else:
                break
    while True:
        c = stream.peek(1)
        if not c or c in (b" ", b"\n", b"\t", b"\r"):
            break
        out += stream.read(1)
    if eat_trailing_space and stream.peek(1) == b" ":
        stream.read(1)
    return out.decode("utf-8", errors="replace")


def expect_token(stream, binary: bool, token: str) -> None:
    got = read_token(stream, binary)
    if got != token:
        raise KaldiIOError("expected token %r, got %r" % (token, got))


def write_token(stream, binary: bool, token: str) -> None:
    stream.write(token.encode("utf-8") + b" ")


_BASIC = {
    "int32": ("<i", 4),
    "int16": ("<h", 2),
    "uint16": ("<H", 2),
    "uint8": ("<B", 1),
    "float32": ("<f", 4),
    "float64": ("<d", 8),
}


def read_basic(stream, binary: bool, kind: str):
    fmt, size = _BASIC[kind]
    if binary:
        marker = stream.read(1)
        if len(marker) != 1:
            raise KaldiIOError("end of stream reading basic-type marker")
        if marker[0] != size:
            raise KaldiIOError(
                "basic-type size marker %d != expected %d for %s"
                % (marker[0], size, kind))
        raw = stream.read(size)
        if len(raw) != size:
            raise KaldiIOError("short read for basic type %s" % kind)
        return struct.unpack(fmt, raw)[0]
    text = read_token(stream, binary)
    if kind in ("float32", "float64"):
        return float(text)
    return int(text)


def write_basic(stream, binary: bool, kind: str, value) -> None:
    fmt, size = _BASIC[kind]
    if binary:
        stream.write(bytes([size]))
        stream.write(struct.pack(fmt, value))
    else:
        stream.write(("%s " % value).encode("utf-8"))


def read_int32(stream, binary: bool) -> int:
    return read_basic(stream, binary, "int32")


def read_float(stream, binary: bool) -> float:
    return read_basic(stream, binary, "float32")


# ---------------------------------------------------------------------------
# Compressed matrices (decode + encode)
# ---------------------------------------------------------------------------

_U16_SCALE = 1.0 / 65535.0


def _u16_to_float(min_value: float, rng: float, codes: np.ndarray) -> np.ndarray:
    return (min_value + rng * _U16_SCALE * codes.astype(np.float32)).astype(
        np.float32)


def _decode_cm1_columns(codes_u8: np.ndarray, p0, p25, p75, p100) -> np.ndarray:
    """Vectorized piecewise-linear uint8 → float decode.

    codes_u8: [cols, rows] uint8; p*: [cols] float32 per-column percentiles.
    Segments (Kaldi spec): code<=64 → [p0,p25]; 64<code<=192 → [p25,p75];
    code>192 → [p75,p100].
    """
    c = codes_u8.astype(np.float32)
    p0 = p0[:, None]
    p25 = p25[:, None]
    p75 = p75[:, None]
    p100 = p100[:, None]
    low = p0 + (p25 - p0) * (c * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
    out = np.where(c <= 64.0, low, np.where(c <= 192.0, mid, high))
    return out.astype(np.float32).T  # [rows, cols]


def read_compressed_matrix(stream, token: str) -> np.ndarray:
    """Decode a CM/CM2 compressed matrix; the token has been consumed."""
    min_value, rng = struct.unpack("<ff", stream.read(8))
    rows, cols = struct.unpack("<ii", stream.read(8))
    if token == "CM":
        headers = np.frombuffer(stream.read(2 * 4 * cols), dtype="<u2")
        headers = headers.reshape(cols, 4)
        p = _u16_to_float(min_value, rng, headers)  # [cols, 4]
        codes = np.frombuffer(stream.read(rows * cols), dtype=np.uint8)
        codes = codes.reshape(cols, rows)
        return _decode_cm1_columns(codes, p[:, 0], p[:, 1], p[:, 2], p[:, 3])
    if token == "CM2":
        codes = np.frombuffer(stream.read(2 * rows * cols), dtype="<u2")
        return _u16_to_float(min_value, rng, codes.reshape(rows, cols))
    if token == "CM3":
        # one byte per element on the global [min, min+range] scale
        codes = np.frombuffer(stream.read(rows * cols), dtype=np.uint8)
        out = min_value + rng * (1.0 / 255.0) * codes.astype(np.float32)
        return out.reshape(rows, cols).astype(np.float32)
    raise KaldiIOError("unsupported compressed-matrix token %r" % token)


def _float_to_u16(min_value: float, rng: float, values: np.ndarray) -> np.ndarray:
    f = (values - min_value) / max(rng, 1e-20) * 65535.0
    return np.clip(np.round(f), 0, 65535).astype("<u2")


def write_compressed_matrix(stream, mat: np.ndarray) -> None:
    """Encode float32 matrix as Kaldi CM (rows>8) or CM2, binary only."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    min_value = float(mat.min()) if mat.size else 0.0
    max_value = float(mat.max()) if mat.size else 1.0
    rng = max(max_value - min_value, 1e-10)
    if rows > 8:
        write_token(stream, True, "CM")
        stream.write(struct.pack("<ffii", min_value, rng, rows, cols))
        colwise = mat.T  # [cols, rows]
        srt = np.sort(colwise, axis=1)
        q0 = srt[:, 0]
        q25 = srt[:, min(rows - 1, max(1, rows // 4))]
        q75 = srt[:, min(rows - 1, max(2, (3 * rows) // 4))]
        q100 = srt[:, rows - 1]
        # quantize percentiles to the u16 grid (that is what gets stored)
        hdr = np.stack([
            _float_to_u16(min_value, rng, q0),
            _float_to_u16(min_value, rng, q25),
            _float_to_u16(min_value, rng, q75),
            _float_to_u16(min_value, rng, q100),
        ], axis=1)  # [cols, 4]
        stream.write(hdr.astype("<u2").tobytes())
        p = _u16_to_float(min_value, rng, hdr)  # decoded percentiles
        p0, p25, p75, p100 = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
        # piecewise-linear inverse of _decode_cm1_columns
        v = colwise
        code_low = (v - p0) / np.maximum(p25 - p0, 1e-20) * 64.0
        code_mid = 64.0 + (v - p25) / np.maximum(p75 - p25, 1e-20) * 128.0
        code_high = 192.0 + (v - p75) / np.maximum(p100 - p75, 1e-20) * 63.0
        codes = np.where(v < p25, code_low,
                         np.where(v <= p75, code_mid, code_high))
        codes = np.clip(np.round(codes), 0, 255).astype(np.uint8)
        stream.write(codes.tobytes())
    else:
        write_token(stream, True, "CM2")
        stream.write(struct.pack("<ffii", min_value, rng, rows, cols))
        stream.write(_float_to_u16(min_value, rng, mat).tobytes())


# ---------------------------------------------------------------------------
# Matrices / vectors
# ---------------------------------------------------------------------------

def _read_text_numbers_until(stream, terminator: str) -> List[List[float]]:
    """Read whitespace-separated numbers until a lone ``]`` token."""
    rows: List[List[float]] = [[]]
    while True:
        tok = read_token(stream, binary=False)
        if tok == "":
            raise KaldiIOError("end of stream inside text matrix")
        if tok == terminator:
            break
        if tok.endswith(terminator):
            rows[-1].append(float(tok[:-1]))
            break
        rows[-1].append(float(tok))
        # row break = any run of spaces/CR ending in a newline (Kaldi
        # emits "val val \n"; tolerate CRLF and extra trailing spaces —
        # a strict single-'\n' peek silently merged all rows into one)
        while stream.peek(1) in (b" ", b"\r"):
            stream.read(1)
        if stream.peek(1) == b"\n":
            stream.read(1)
            if rows[-1]:
                rows.append([])
    if rows and not rows[-1]:
        rows.pop()
    return rows


def read_matrix(stream, binary: bool) -> np.ndarray:
    """Read FM/DM/CM/CM2 binary or ``[ ... ]`` text matrices."""
    if binary:
        peeked = stream.peek(1)
        if peeked == b"C":
            token = read_token(stream, binary, eat_trailing_space=False)
            stream.read(1)  # the space after CM/CM2
            try:
                return read_compressed_matrix(stream, token)
            except (struct.error, ValueError) as exc:
                # keep the module's error contract so permissive ('p')
                # readers can skip truncated/corrupt entries
                raise KaldiIOError("bad compressed matrix: %s" % exc)
        token = read_token(stream, binary)
        if token == "FM":
            dtype, itemsize = np.dtype("<f4"), 4
        elif token == "DM":
            dtype, itemsize = np.dtype("<f8"), 8
        else:
            raise KaldiIOError("unknown matrix token %r" % token)
        rows = read_int32(stream, binary)
        cols = read_int32(stream, binary)
        data = stream.read(itemsize * rows * cols)
        if len(data) != itemsize * rows * cols:
            raise KaldiIOError("short read in matrix payload")
        # float64 (DM) payloads keep their precision (CMVN stats);
        # copy: frombuffer views are read-only, callers may mutate
        arr = np.frombuffer(data, dtype=dtype).reshape(rows, cols)
        return np.array(arr)
    # Text: optional leading spaces then '[' rows... ']'
    tok = read_token(stream, binary=False)
    if tok != "[":
        raise KaldiIOError("expected '[' starting text matrix, got %r" % tok)
    rows = _read_text_numbers_until(stream, "]")
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    return np.asarray(rows, dtype=np.float32)


def write_matrix(stream, binary: bool, mat: np.ndarray,
                 compress: bool = False, double: bool = False) -> None:
    mat = np.atleast_2d(np.asarray(mat))
    if binary:
        if compress:
            write_compressed_matrix(stream, mat)
            return
        write_token(stream, binary, "DM" if double else "FM")
        write_basic(stream, binary, "int32", mat.shape[0])
        write_basic(stream, binary, "int32", mat.shape[1])
        dtype = "<f8" if double else "<f4"
        stream.write(np.ascontiguousarray(mat, dtype=dtype).tobytes())
    else:
        if not mat.shape[0] or not mat.shape[1]:
            stream.write(b" []\n")
            return
        stream.write(b" [")
        for row in mat:
            stream.write(b"\n  ")
            stream.write(" ".join("%f" % v for v in row).encode("utf-8"))
            stream.write(b" ")
        stream.write(b"]\n")


def read_vector(stream, binary: bool) -> np.ndarray:
    if binary:
        peeked = stream.peek(1)
        if peeked == b"C":
            token = read_token(stream, binary, eat_trailing_space=False)
            stream.read(1)
            return read_compressed_matrix(stream, token).reshape(-1)
        token = read_token(stream, binary)
        if token == "FV":
            dtype, itemsize = np.dtype("<f4"), 4
        elif token == "DV":
            dtype, itemsize = np.dtype("<f8"), 8
        else:
            raise KaldiIOError("unknown vector token %r" % token)
        size = read_int32(stream, binary)
        data = stream.read(itemsize * size)
        if len(data) != itemsize * size:
            raise KaldiIOError("short read in vector payload")
        # copy: frombuffer views are read-only, callers may mutate
        return np.frombuffer(data, dtype=dtype).astype(np.float32, copy=True)
    tok = read_token(stream, binary=False)
    if tok != "[":
        raise KaldiIOError("expected '[' starting text vector, got %r" % tok)
    vals: List[float] = []
    while True:
        tok = read_token(stream, binary=False)
        if tok == "]" or tok == "":
            break
        if tok.endswith("]"):
            vals.append(float(tok[:-1]))
            break
        vals.append(float(tok))
    return np.asarray(vals, dtype=np.float32)


def write_vector(stream, binary: bool, vec: np.ndarray) -> None:
    vec = np.asarray(vec).reshape(-1)
    if binary:
        write_token(stream, binary, "FV")
        write_basic(stream, binary, "int32", vec.shape[0])
        stream.write(np.ascontiguousarray(vec, dtype="<f4").tobytes())
    else:
        if not vec.shape[0]:
            stream.write(b" []\n")
        else:
            stream.write(b" [ ")
            stream.write(" ".join("%f" % v for v in vec).encode("utf-8"))
            stream.write(b" ]\n")


# ---------------------------------------------------------------------------
# std::vector<int32> (Kaldi BasicVectorHolder wire format)
# ---------------------------------------------------------------------------

def read_int32_vector(stream, binary: bool) -> np.ndarray:
    if binary:
        size = read_int32(stream, binary)
        if size < 0:
            raise KaldiIOError("negative int32-vector size %d" % size)
        # each element carries its own 1-byte size marker: strided decode
        raw = stream.read(5 * size)
        if len(raw) != 5 * size:
            raise KaldiIOError("short read in int32 vector")
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(size, 5)
        if size and not (arr[:, 0] == 4).all():
            raise KaldiIOError("corrupt int32-vector element marker")
        return arr[:, 1:5].copy().view("<i4").reshape(-1)
    line = stream.readline()
    return np.asarray([int(x) for x in line.split()], dtype=np.int32)


def write_int32_vector(stream, binary: bool, vec: np.ndarray) -> None:
    vec = np.asarray(vec, dtype="<i4").reshape(-1)
    if binary:
        write_basic(stream, binary, "int32", vec.shape[0])
        out = np.empty((vec.shape[0], 5), dtype=np.uint8)
        out[:, 0] = 4
        out[:, 1:5] = vec.view(np.uint8).reshape(-1, 4)
        stream.write(out.tobytes())
    else:
        stream.write(" ".join(str(int(v)) for v in vec).encode("utf-8"))
        stream.write(b" \n" if vec.shape[0] else b"\n")


# ---------------------------------------------------------------------------
# Posteriors: vector<vector<pair<int32, float>>>
# ---------------------------------------------------------------------------

def read_posterior(stream, binary: bool) -> List[List[Tuple[int, float]]]:
    if binary:
        num_frames = read_int32(stream, binary)
        if num_frames < 0 or num_frames > 100000000:
            raise KaldiIOError("implausible posterior size %d" % num_frames)
        post = []
        for _ in range(num_frames):
            pairs = []
            num_pairs = read_int32(stream, binary)
            for _ in range(num_pairs):
                label = read_int32(stream, binary)
                prob = read_float(stream, binary)
                pairs.append((label, prob))
            post.append(pairs)
        return post
    line = stream.readline()
    post = []
    frame: List[Tuple[int, float]] = []
    tokens = line.split()
    i = 0
    while i < len(tokens):
        if tokens[i] == "[":
            frame = []
            i += 1
        elif tokens[i] == "]":
            post.append(frame)
            i += 1
        else:
            frame.append((int(tokens[i]), float(tokens[i + 1])))
            i += 2
    return post


def write_posterior(stream, binary: bool,
                    post: List[List[Tuple[int, float]]]) -> None:
    if binary:
        write_basic(stream, binary, "int32", len(post))
        for frame in post:
            write_basic(stream, binary, "int32", len(frame))
            for label, prob in frame:
                write_basic(stream, binary, "int32", int(label))
                write_basic(stream, binary, "float32", float(prob))
    else:
        parts = []
        for frame in post:
            parts.append("[")
            for label, prob in frame:
                parts.append(str(int(label)))
                parts.append("%f" % prob)
            parts.append("]")
        stream.write((" ".join(parts) + " \n").encode("utf-8"))
