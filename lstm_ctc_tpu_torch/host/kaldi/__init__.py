"""Kaldi-compatible binary I/O runtime (host side).

The port's copy of ``lstm_ctc_tpu/kaldi/``: binio, specifiers, streams,
table, and the nnet1 model reader, the nnet3 example reader and the
frame randomizers.  Public surface mirrors the reference's pyKaldiIO
package (reference pyKaldiIO/__init__.py:15-34).
"""

from .binio import (
    KaldiIOError,
    read_matrix,
    read_vector,
    read_int32_vector,
    read_posterior,
    write_matrix,
    write_vector,
    write_int32_vector,
    write_posterior,
)
from .specifiers import (
    InputKind,
    OutputKind,
    classify_rxfilename,
    classify_wxfilename,
    parse_rspecifier,
    parse_wspecifier,
)
from .streams import Input, InputStream, Output, OutputStream, open_input, open_output
from .table import RandomAccessTableReader, SequentialTableReader, TableWriter
from .nnet_example import NnetExample, NnetIo, read_nnet_example
from .nnet1 import Nnet1Model
from .randomizer import (
    FloatVectorRandomizer,
    Int32VectorRandomizer,
    MatrixRandomizer,
    NnetDataRandomizerOptions,
    RandomizerMask,
)


def is_token(text: str) -> bool:
    """Printable, non-empty, whitespace-free table key (reference
    pyKaldiIO/text_util.py:20-26)."""
    return bool(text) and not any(c.isspace() for c in text) \
        and text.isprintable()


# --- reference-compatible typed wrappers (pyKaldiIO/kaldi_table.py:1064-1142)

class SequentialBaseFloatMatrixReader(SequentialTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "matrix")


class SequentialBaseFloatVectorReader(SequentialTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "vector")


class SequentialInt32VectorReader(SequentialTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "int32vec")


class RandomAccessBaseFloatMatrixReader(RandomAccessTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "matrix")


class RandomAccessFloatVectorReader(RandomAccessTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "vector")


class RandomAccessInt32VectorReader(RandomAccessTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "int32vec")


class RandomAccessPosteriorReader(RandomAccessTableReader):
    def __init__(self, rspecifier):
        super().__init__(rspecifier, "posterior")


class BaseFloatMatrixWriter(TableWriter):
    def __init__(self, wspecifier):
        super().__init__(wspecifier, "matrix")


class BaseFloatVectorWriter(TableWriter):
    def __init__(self, wspecifier):
        super().__init__(wspecifier, "vector")


class Int32VectorWriter(TableWriter):
    def __init__(self, wspecifier):
        super().__init__(wspecifier, "int32vec")


class PosteriorWriter(TableWriter):
    def __init__(self, wspecifier):
        super().__init__(wspecifier, "posterior")
