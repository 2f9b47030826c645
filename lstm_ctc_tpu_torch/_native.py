"""The native WFST, lattice and LM tools of ``native/src``, built for the port.

The recipes' graph, lattice and scoring stages run C++ tools
(``native/CMakeLists.txt``): ``fst-tools``, ``latgen-faster``,
``lattice-tools``, ``lattice-lmrescore``, ``arpa-to-const-arpa``,
``lattice-oracle`` and ``count-ngrams``, the libraries ``librecord_loader.so``
and ``libctc_beam.so``, and the OpenFst- and Kaldi-style names of the first
three as symlinks.  This module compiles the same sources with
``g++ -std=c++17 -O2`` (the compiler ``nvcc`` needs as its host compiler),
with no ``cmake``, into ``lstm_ctc_tpu_torch/build/native/``: at first use,
and again when a source or header is newer than what was built.  One build
serves the CPU and the GPU machine alike.

    python -m lstm_ctc_tpu_torch._native [DIR]   # build all; prints the dir

A recipe then runs with ``FSTBIN`` set to that directory and the directory
first on ``PATH`` (``scripts/score.sh`` and ``decode_ctc_lat.sh`` look on
``PATH`` before ``native/build``).  A failed compile raises; nothing falls
back to another build.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

PACKAGE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(os.path.dirname(PACKAGE), "native", "src")
BUILD_DIR = os.path.join(PACKAGE, "build", "native")

CXX = ["g++", "-std=c++17", "-O2"]
# liblctcfst (CMakeLists.txt:10-18), linked into the tools that use it
LIBRARY_SOURCES = ("fst.cc", "determinize.cc", "minimize.cc", "arpa2fst.cc",
                   "const_arpa.cc", "kaldi_io.cc", "lattice.cc")
TOOLS = {"fst-tools": "fst_tools.cc", "latgen-faster": "latgen.cc",
         "lattice-tools": "lattice_tools.cc",
         "lattice-lmrescore": "lattice_lmrescore.cc",
         "arpa-to-const-arpa": "arpa_to_const_arpa.cc",
         "lattice-oracle": "lattice_oracle.cc"}
STANDALONE = {"count-ngrams": "ngram_count.cc"}
SHARED = {"librecord_loader.so": "record_loader.cc",
          "libctc_beam.so": "ctc_beam.cc"}
# the symlink aliases (CMakeLists.txt:40-43, :55-65)
ALIASES = {
    "fst-tools": ("fstcompile", "fstprint", "fstarcsort", "fsttablecompose",
                  "fstdeterminizestar", "fstminimizeencoded",
                  "fstaddselfloops", "fstrmepsilon", "fstconnect", "fstinfo",
                  "arpa2fst"),
    "lattice-tools": ("lattice-scale", "lattice-best-path", "lattice-prune"),
    "lattice-lmrescore": ("lattice-lmrescore-const-arpa",),
}
TARGETS = ("liblctcfst.a",) + tuple(TOOLS) + tuple(STANDALONE) + tuple(SHARED)


def _sources(target: str) -> List[str]:
    """The sources a target is made from (every header counts for all)."""
    if target == "liblctcfst.a":
        own = list(LIBRARY_SOURCES)
    elif target in TOOLS:
        own = [TOOLS[target]] + list(LIBRARY_SOURCES)
    elif target in STANDALONE:
        own = [STANDALONE[target]]
    else:
        own = [SHARED[target]]
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".h"))
    return [os.path.join(SOURCE_DIR, f) for f in own + headers]


def _stale(target: str, build_dir: str) -> bool:
    path = os.path.join(build_dir, target)
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    return any(os.path.getmtime(src) > built for src in _sources(target))


def _run(cmd: Sequence[str]) -> None:
    proc = subprocess.run(list(cmd), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("native build failed (%d): %s\n%s%s"
                           % (proc.returncode, " ".join(cmd), proc.stdout,
                              proc.stderr))


def _compile(inputs: Sequence[str], out: str, extra: Sequence[str] = ()
             ) -> None:
    """One compile (and link) to ``out``, written to a temporary name and
    renamed into place, so a reader never sees a partial file."""
    tmp = "%s.tmp%d" % (out, os.getpid())
    _run(CXX + list(extra) + ["-I", SOURCE_DIR, "-o", tmp] + list(inputs))
    os.replace(tmp, out)


def _object(source: str, build_dir: str) -> str:
    out = os.path.join(build_dir, source[:-3] + ".o")
    _compile([os.path.join(SOURCE_DIR, source)], out, ["-c"])
    return out


def _build_target(target: str, build_dir: str) -> None:
    out = os.path.join(build_dir, target)
    library = os.path.join(build_dir, "liblctcfst.a")
    if target in TOOLS:
        _compile([os.path.join(SOURCE_DIR, TOOLS[target]), library], out)
    elif target in STANDALONE:
        _compile([os.path.join(SOURCE_DIR, STANDALONE[target])], out)
    else:
        _compile([os.path.join(SOURCE_DIR, SHARED[target])], out,
                 ["-shared", "-fPIC"])


def _link_aliases(build_dir: str) -> None:
    for tool, names in ALIASES.items():
        for name in names:
            path = os.path.join(build_dir, name)
            if os.path.islink(path) and os.readlink(path) == tool:
                continue
            tmp = "%s.tmp%d" % (path, os.getpid())
            os.symlink(tool, tmp)
            os.replace(tmp, path)


def ensure_built(targets: Sequence[str] = TARGETS,
                 build_dir: str = BUILD_DIR) -> Dict:
    """Build ``targets`` (names of ``TARGETS``; all by default) into
    ``build_dir`` where they are missing or older than a source, under a
    lock that concurrent builds share.  Returns {"dir", "built": [names],
    "seconds"}."""
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        raise ValueError("unknown native targets: %s" % unknown)
    start = time.perf_counter()
    build_dir = os.path.abspath(build_dir)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [t for t in targets if _stale(t, build_dir)]
        with ThreadPoolExecutor(os.cpu_count() or 4) as jobs:
            if any(t in TOOLS or t == "liblctcfst.a" for t in todo) and \
                    _stale("liblctcfst.a", build_dir):
                objs = list(jobs.map(lambda s: _object(s, build_dir),
                                     LIBRARY_SOURCES))
                library = os.path.join(build_dir, "liblctcfst.a")
                tmp = "%s.tmp%d" % (library, os.getpid())
                _run(["ar", "rcs", tmp] + objs)
                os.replace(tmp, library)
                for obj in objs:
                    os.remove(obj)
            list(jobs.map(lambda t: _build_target(t, build_dir),
                          [t for t in todo if t != "liblctcfst.a"]))
        if any(t in ALIASES for t in targets):
            _link_aliases(build_dir)
    return {"dir": build_dir, "built": todo,
            "seconds": time.perf_counter() - start}


if __name__ == "__main__":
    info = ensure_built(build_dir=sys.argv[1] if len(sys.argv) > 1
                        else BUILD_DIR)
    print("built %d targets in %.1f s" % (len(info["built"]),
                                          info["seconds"]), file=sys.stderr)
    print(info["dir"])
