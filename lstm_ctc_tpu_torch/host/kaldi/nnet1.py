"""Kaldi nnet1 binary model reader (weight import).

Capability mirror of reference pyKaldiIO/nnet_nnet1.py:104-156: parses a
sequence of components (<AffineTransform>/<Sigmoid>/<Softmax> plus the
common elementwise components) for importing legacy DNN weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .binio import (
    KaldiIOError,
    expect_token,
    read_basic,
    read_int32,
    read_matrix,
    read_token,
    read_vector,
)
from .streams import Input


@dataclass
class Nnet1Component:
    kind: str
    input_dim: int
    output_dim: int
    linearity: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None


_PARAM_TOKENS = {
    "<LearnRateCoef>", "<BiasLearnRateCoef>", "<MaxNorm>", "<ClipGradient>",
}

_PARAMETRIC = {"<AffineTransform>", "<LinearTransform>"}
_ELEMENTWISE = {"<Sigmoid>", "<Softmax>", "<Tanh>", "<ReLU>", "<Dropout>"}


def _read_component(stream, binary: bool) -> Optional[Nnet1Component]:
    token = read_token(stream, binary)
    if token == "<Nnet>":
        token = read_token(stream, binary)
    if token == "</Nnet>" or token == "":
        return None
    # Kaldi nnet1 Component::Write emits OutputDim() THEN InputDim()
    # (reference pyKaldiIO/nnet_nnet1.py reads in that order too)
    output_dim = read_int32(stream, binary)
    input_dim = read_int32(stream, binary)
    comp = Nnet1Component(token.strip("<>"), input_dim, output_dim)
    if token in _PARAMETRIC:
        # optional <Token> float parameters in arbitrary order
        while stream.peek(1) == b"<":
            tok = read_token(stream, binary)
            if tok == "<!EndOfComponent>":
                return comp
            if tok not in _PARAM_TOKENS:
                raise KaldiIOError("unknown nnet1 token %r" % tok)
            read_basic(stream, binary, "float32")
        comp.linearity = read_matrix(stream, binary)
        if token == "<AffineTransform>":
            comp.bias = read_vector(stream, binary)
    elif token not in _ELEMENTWISE:
        raise KaldiIOError("unsupported nnet1 component %r" % token)
    if stream.peek(2) == b"<!":
        expect_token(stream, binary, "<!EndOfComponent>")
    return comp


class Nnet1Model:
    """Parsed nnet1 model: a list of components in network order."""

    def __init__(self, rxfilename: Optional[str] = None):
        self.components: List[Nnet1Component] = []
        if rxfilename is not None:
            with Input(rxfilename) as inp:
                self.read(inp.stream(), inp.binary)

    def read(self, stream, binary: bool) -> None:
        if not binary:
            raise KaldiIOError("text-mode nnet1 models not supported; "
                               "convert with Kaldi nnet-copy first")
        while True:
            comp = _read_component(stream, binary)
            if comp is None:
                break
            self.components.append(comp)

    def num_components(self) -> int:
        return len(self.components)

    def dump_component(self, idx: int) -> Tuple[str, list]:
        comp = self.components[idx]
        params = [p for p in (comp.linearity, comp.bias) if p is not None]
        return comp.kind, params
