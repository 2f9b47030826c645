"""Buffered byte streams over files, stdin/stdout, shell pipes and offsets.

The Kaldi ecosystem passes data between tools through "extended filenames":
plain files, ``-`` (stdio), ``cmd |`` / ``| cmd`` shell pipelines, and
``file.ark:12345`` byte offsets (reference pyKaldiIO/kaldi_io.py:238-283 and
:351-429 reimplement the same idea).  InputStream/OutputStream here are thin
peekable binary wrappers used by all codecs in binio.py.
"""

from __future__ import annotations

import io
import subprocess
import sys
from typing import Optional

from . import specifiers
from .binio import KaldiIOError


class InputStream:
    """Peekable buffered binary reader."""

    def __init__(self, raw, process: Optional[subprocess.Popen] = None,
                 name: str = ""):
        self._raw = raw
        self._process = process
        self._buf = b""
        self.name = name

    def peek(self, n: int = 1) -> bytes:
        while len(self._buf) < n:
            chunk = self._raw.read(n - len(self._buf))
            if not chunk:
                break
            self._buf += chunk
        return self._buf[:n]

    def read(self, n: int) -> bytes:
        out = b""
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            n -= len(out)
        if n > 0:
            rest = self._raw.read(n)
            if rest:
                out += rest
        return out

    def readline(self) -> str:
        out = bytearray()
        while True:
            c = self.read(1)
            if not c or c == b"\n":
                break
            out += c
        return out.decode("utf-8", errors="replace")

    def eof(self) -> bool:
        return self.peek(1) == b""

    def close(self) -> None:
        if self._raw not in (None, sys.stdin.buffer):
            try:
                self._raw.close()
            except OSError:
                pass
        if self._process is not None:
            returncode = self._process.wait()
            # SIGPIPE deaths (-13 direct, 141 through a shell) are the
            # normal outcome of this consumer closing the pipe early
            if returncode not in (0, -13, 141):
                raise KaldiIOError(
                    "input pipe %r exited with status %d"
                    % (self.name, returncode))
            self._process = None


class OutputStream:
    """Buffered binary writer with byte-offset tracking (for scp entries)."""

    def __init__(self, raw, process: Optional[subprocess.Popen] = None,
                 name: str = ""):
        self._raw = raw
        self._process = process
        self.name = name
        self._offset = 0

    def write(self, data: bytes) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        try:
            self._raw.write(data)
        except BrokenPipeError:
            # the pipe consumer died mid-stream: reap it now and raise
            # the module's error with the exit status instead of EPIPE
            status = None
            if self._process is not None:
                status = self._process.wait()
                self._process = None
            raise KaldiIOError(
                "output pipe %r closed early (broken pipe%s)"
                % (self.name,
                   "" if status is None else ", exit status %d" % status))
        self._offset += len(data)

    def tell(self) -> int:
        return self._offset

    def flush(self) -> None:
        self._raw.flush()

    def close(self) -> None:
        # a dead pipe consumer makes the final flush raise BrokenPipe;
        # ALWAYS reap the child first so it is never left a zombie and
        # the informative exit-status error wins over the raw EPIPE
        flush_exc = None
        try:
            if self._raw not in (None, sys.stdout.buffer):
                self._raw.close()
            else:
                self._raw.flush()
        except BrokenPipeError as exc:
            flush_exc = exc
        if self._process is not None:
            returncode = self._process.wait()
            self._process = None
            if returncode != 0:
                raise KaldiIOError(
                    "output pipe %r exited with status %d"
                    % (self.name, returncode))
        if flush_exc is not None:
            raise KaldiIOError(
                "output pipe %r closed early (broken pipe)" % self.name)


def open_input(rxfilename: str, bufsize: int = 1 << 16) -> InputStream:
    kind = specifiers.classify_rxfilename(rxfilename)
    if kind == specifiers.InputKind.STDIN:
        return InputStream(sys.stdin.buffer, name="-")
    if kind == specifiers.InputKind.FILE:
        return InputStream(open(rxfilename, "rb", buffering=bufsize),
                           name=rxfilename)
    if kind == specifiers.InputKind.OFFSET:
        path, offset = specifiers._split_trailing_offset(rxfilename)
        fh = open(path, "rb", buffering=bufsize)
        fh.seek(offset)
        return InputStream(fh, name=rxfilename)
    if kind == specifiers.InputKind.PIPE:
        cmd = rxfilename.rstrip().rstrip("|")
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE,
                                bufsize=bufsize)
        return InputStream(proc.stdout, process=proc, name=rxfilename)
    raise KaldiIOError("cannot open %r for reading" % rxfilename)


def open_output(wxfilename: str, bufsize: int = 1 << 16) -> OutputStream:
    kind = specifiers.classify_wxfilename(wxfilename)
    if kind == specifiers.OutputKind.STDOUT:
        return OutputStream(sys.stdout.buffer, name="-")
    if kind == specifiers.OutputKind.FILE:
        return OutputStream(open(wxfilename, "wb", buffering=bufsize),
                            name=wxfilename)
    if kind == specifiers.OutputKind.PIPE:
        cmd = wxfilename.lstrip().lstrip("|")
        proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE,
                                bufsize=bufsize)
        return OutputStream(proc.stdin, process=proc, name=wxfilename)
    raise KaldiIOError("cannot open %r for writing" % wxfilename)


class Input:
    """Object-level input: opens an rxfilename and strips the binary header.

    Mirrors Kaldi's ``Input`` / the reference's pyKaldiIO.Input
    (kaldi_io.py:351-429): ``stream, binary = Input(rxfilename).stream()``.
    """

    def __init__(self, rxfilename: str, read_header: bool = True):
        from .binio import init_input_stream
        self._stream = open_input(rxfilename)
        self.binary = init_input_stream(self._stream) if read_header else None

    def stream(self) -> InputStream:
        return self._stream

    def Stream(self) -> InputStream:  # reference-compatible alias
        return self._stream

    def close(self) -> None:
        self._stream.close()

    Close = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Output:
    """Object-level output: opens a wxfilename and writes the binary header."""

    def __init__(self, wxfilename: str, binary: bool = True,
                 write_header: bool = True):
        from .binio import init_output_stream
        self._stream = open_output(wxfilename)
        self.binary = binary
        if write_header:
            init_output_stream(self._stream, binary)

    def stream(self) -> OutputStream:
        return self._stream

    Stream = stream

    def close(self) -> None:
        self._stream.close()

    Close = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
