"""Kaldi extended-filename and table-specifier classification.

Semantics follow Kaldi's kaldi-io.cc / kaldi-table.cc (and the reference's
pure-Python rendition, pyKaldiIO/io_funcs.py:256-563):

  rxfilename kinds: "" or "-" → stdin; "cmd |" → input pipe;
  "file:12345" → byte offset into file; otherwise plain file.
  wxfilename kinds: "" or "-" → stdout; "| cmd" → output pipe; plain file.

  rspecifier: "[opts,]ark:rx" or "[opts,]scp:rx" with option letters
  o/no (once), s/ns (sorted), cs/ncs (called-sorted), p/np (permissive),
  bg (background read-ahead), b/t (ignored on input).

  wspecifier: "ark:wx", "scp:wx", "ark,scp:wx,wx" with b/t (binary/text),
  f/nf (flush), p (permissive).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class InputKind(enum.Enum):
    NONE = 0
    FILE = 1
    STDIN = 2
    PIPE = 3
    OFFSET = 4


class OutputKind(enum.Enum):
    NONE = 0
    FILE = 1
    STDOUT = 2
    PIPE = 3


def _split_trailing_offset(filename: str):
    """Return (path, offset) for names like /a/b.ark:12345, else (name, None)."""
    if not filename or not filename[-1].isdigit():
        return filename, None
    i = len(filename) - 1
    while i >= 0 and filename[i].isdigit():
        i -= 1
    if i >= 0 and filename[i] == ":":
        return filename[:i], int(filename[i + 1:])
    return filename, None


def classify_rxfilename(filename: str) -> InputKind:
    if not filename or filename == "-":
        return InputKind.STDIN
    if filename.startswith("|"):
        return InputKind.NONE
    if filename != filename.strip(" "):
        return InputKind.NONE
    if filename.startswith(("t,", "b,")):
        return InputKind.NONE
    if filename.endswith("|"):
        return InputKind.PIPE
    _, offset = _split_trailing_offset(filename)
    if offset is not None:
        return InputKind.OFFSET
    return InputKind.FILE


def classify_wxfilename(filename: str) -> OutputKind:
    if not filename or filename == "-":
        return OutputKind.STDOUT
    if filename.startswith("|"):
        return OutputKind.PIPE
    if filename != filename.strip(" "):
        return OutputKind.NONE
    if filename.startswith(("t,", "b,")):
        return OutputKind.NONE
    if filename.endswith("|"):
        return OutputKind.NONE
    _, offset = _split_trailing_offset(filename)
    if offset is not None:
        return OutputKind.NONE
    return OutputKind.FILE


@dataclass
class Rspecifier:
    kind: str = ""            # "ark" or "scp"
    rxfilename: str = ""
    once: bool = False
    sorted: bool = False
    called_sorted: bool = False
    permissive: bool = False
    background: bool = False


@dataclass
class Wspecifier:
    kind: str = ""            # "ark", "scp", or "both"
    archive_wxfilename: str = ""
    script_wxfilename: str = ""
    binary: bool = True
    flush: bool = False
    permissive: bool = False


def parse_rspecifier(rspecifier: str) -> Rspecifier:
    spec = Rspecifier()
    pos = rspecifier.find(":")
    if pos < 0 or rspecifier.endswith(" "):
        raise ValueError("malformed rspecifier: %r" % rspecifier)
    flags = {
        "o": ("once", True), "no": ("once", False),
        "s": ("sorted", True), "ns": ("sorted", False),
        "cs": ("called_sorted", True), "ncs": ("called_sorted", False),
        "p": ("permissive", True), "np": ("permissive", False),
        "bg": ("background", True),
    }
    for part in rspecifier[:pos].split(","):
        part = part.strip()
        if part in ("b", "t", ""):
            continue
        if part in ("ark", "scp"):
            if spec.kind:
                raise ValueError("repeated table type in %r" % rspecifier)
            spec.kind = part
        elif part in flags:
            name, val = flags[part]
            setattr(spec, name, val)
        else:
            raise ValueError("bad rspecifier option %r in %r"
                             % (part, rspecifier))
    if not spec.kind:
        raise ValueError("no ark:/scp: in rspecifier %r" % rspecifier)
    spec.rxfilename = rspecifier[pos + 1:]
    return spec


def parse_wspecifier(wspecifier: str) -> Wspecifier:
    spec = Wspecifier()
    pos = wspecifier.find(":")
    if pos < 0 or wspecifier.endswith(" "):
        raise ValueError("malformed wspecifier: %r" % wspecifier)
    saw_ark = saw_scp = False
    for part in wspecifier[:pos].split(","):
        part = part.strip()
        if part == "":
            continue
        if part == "b":
            spec.binary = True
        elif part == "t":
            spec.binary = False
        elif part == "f":
            spec.flush = True
        elif part == "nf":
            spec.flush = False
        elif part == "p":
            spec.permissive = True
        elif part == "ark":
            if saw_ark or saw_scp:
                raise ValueError("bad table types in %r" % wspecifier)
            saw_ark = True
        elif part == "scp":
            if saw_scp:
                raise ValueError("bad table types in %r" % wspecifier)
            saw_scp = True
        else:
            raise ValueError("bad wspecifier option %r in %r"
                             % (part, wspecifier))
    after = wspecifier[pos + 1:]
    if saw_ark and saw_scp:
        spec.kind = "both"
        comma = after.find(",")
        if comma < 0:
            raise ValueError("ark,scp wspecifier needs two filenames: %r"
                             % wspecifier)
        spec.archive_wxfilename = after[:comma]
        spec.script_wxfilename = after[comma + 1:]
    elif saw_ark:
        spec.kind = "ark"
        spec.archive_wxfilename = after
    elif saw_scp:
        spec.kind = "scp"
        spec.script_wxfilename = after
    else:
        raise ValueError("no ark:/scp: in wspecifier %r" % wspecifier)
    return spec
