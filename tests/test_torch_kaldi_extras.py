"""The port's copies of the nnet3 example reader, the nnet1 model reader,
the frame randomizers and the n-best utilities (``lstm_ctc_tpu_torch/host/
kaldi/{nnet_example,nnet1,randomizer}.py``, ``host/nbest.py``): the cases
of ``tests/test_kaldi_extras.py`` and ``tests/test_ctc.py``'s n-best cases,
run on the port's modules, each output equal to the reference module's on
the same inputs."""

import io
import struct

import numpy as np
import pytest

from lstm_ctc_tpu import kaldi as ref_kaldi
from lstm_ctc_tpu.ops import nbest as ref_nbest
from lstm_ctc_tpu_torch.host import kaldi, nbest
from lstm_ctc_tpu_torch.host.kaldi import binio
from lstm_ctc_tpu_torch.host.kaldi.streams import OutputStream


def out_stream():
    buf = io.BytesIO()
    return OutputStream(buf), buf


def wtok(out, tok):
    out.write(tok.encode() + b" ")


def wi32(out, v):
    out.write(b"\x04" + struct.pack("<i", v))


def nnet3_example_bytes():
    """A binary <Nnet3Eg> with dense input and sparse output."""
    out, buf = out_stream()
    wtok(out, "<Nnet3Eg>")
    wtok(out, "<NumIo>")
    wi32(out, 2)
    wtok(out, "<NnetIo>")
    wtok(out, "input")
    wtok(out, "<I1V>")
    wi32(out, 3)
    out.write(struct.pack("b", 127))  # escape: explicit n,t,x
    wi32(out, 0)
    wi32(out, -1)                     # negative t
    wi32(out, 0)
    out.write(struct.pack("b", 1))    # delta +1
    out.write(struct.pack("b", 1))
    feats = np.arange(6, dtype=np.float32).reshape(3, 2)
    binio.write_matrix(out, True, feats)
    wtok(out, "</NnetIo>")
    wtok(out, "<NnetIo>")
    wtok(out, "output")
    wtok(out, "<I1V>")
    wi32(out, 1)
    out.write(struct.pack("b", 127))
    wi32(out, 0)
    wi32(out, 0)
    wi32(out, 0)
    wtok(out, "SM")
    wi32(out, 1)          # rows
    wtok(out, "SV")
    wi32(out, 10)         # dim
    wi32(out, 1)          # one element
    wi32(out, 7)          # label index
    out.write(b"\x04" + struct.pack("<f", 1.0))
    wtok(out, "</NnetIo>")
    wtok(out, "</Nnet3Eg>")
    return buf.getvalue(), feats


def read_example(pkg, data):
    return pkg.nnet_example.read_nnet_example(
        pkg.streams.InputStream(io.BytesIO(data)), binary=True)


def test_nnet3_example_reader_matches_reference():
    data, feats = nnet3_example_bytes()
    eg = read_example(kaldi, data)
    ref = read_example(ref_kaldi, data)
    np.testing.assert_array_equal(eg.get_feature("input"), feats)
    assert eg.get_label("output") == [7]
    assert eg.io[0].indexes[0].t == -1
    assert eg.io[0].indexes[2].t == 1
    assert [io_.name for io_ in eg.io] == [io_.name for io_ in ref.io]
    for a, b in zip(eg.io, ref.io):
        assert [(i.n, i.t, i.x) for i in a.indexes] == \
            [(i.n, i.t, i.x) for i in b.indexes]
    np.testing.assert_array_equal(eg.get_feature("input"),
                                  ref.get_feature("input"))
    assert eg.get_label("output") == ref.get_label("output")


def test_nnet1_model_reader_matches_reference(tmp_path):
    out, buf = out_stream()
    out.write(b"\x00B")
    wtok(out, "<Nnet>")
    wtok(out, "<AffineTransform>")
    wi32(out, 3)   # Kaldi wire order: output_dim first ...
    wi32(out, 2)   # ... then input_dim
    wtok(out, "<LearnRateCoef>")
    out.write(b"\x04" + struct.pack("<f", 1.0))
    lin = np.arange(6, dtype=np.float32).reshape(3, 2)
    binio.write_matrix(out, True, lin)
    binio.write_vector(out, True, np.zeros(3, np.float32))
    wtok(out, "<!EndOfComponent>")
    wtok(out, "<Sigmoid>")
    wi32(out, 3)
    wi32(out, 3)
    wtok(out, "<!EndOfComponent>")
    wtok(out, "</Nnet>")
    path = tmp_path / "final.nnet1"
    path.write_bytes(buf.getvalue())

    model = kaldi.Nnet1Model(str(path))
    ref = ref_kaldi.Nnet1Model(str(path))
    assert model.num_components() == ref.num_components() == 2
    kind, params = model.dump_component(0)
    ref_kind, ref_params = ref.dump_component(0)
    assert kind == ref_kind == "AffineTransform"
    np.testing.assert_array_equal(params[0], lin)
    for a, b in zip(params, ref_params):
        np.testing.assert_array_equal(a, b)
    assert model.components[0].output_dim == 3
    assert model.components[0].input_dim == 2
    assert [(c.kind, c.input_dim, c.output_dim) for c in model.components] \
        == [(c.kind, c.input_dim, c.output_dim) for c in ref.components]


def randomized(pkg):
    opts = pkg.NnetDataRandomizerOptions(randomizer_size=8,
                                         randomizer_seed=1, minibatch_size=4)
    rand = pkg.MatrixRandomizer(opts)
    mask = pkg.RandomizerMask(opts).generate(12)
    rand.add_data(np.arange(24, dtype=np.float32).reshape(12, 2))
    assert rand.is_full()
    rand.randomize(mask)
    batches = []
    while not rand.done():
        batches.append(rand.value())
        rand.next()
    return mask, batches


def test_matrix_randomizer_matches_reference():
    mask, batches = randomized(kaldi)
    ref_mask, ref_batches = randomized(ref_kaldi)
    np.testing.assert_array_equal(mask, ref_mask)
    assert len(batches) == len(ref_batches) > 0
    seen = []
    for got, ref in zip(batches, ref_batches):
        assert got.shape == (4, 2)
        np.testing.assert_array_equal(got, ref)
        seen.extend(got[:, 0].tolist())
    assert set(seen) <= set(np.arange(0, 24, 2, dtype=np.float32).tolist())


def test_nbest_utilities_match_reference():
    # peaked log-probs: best path "0 1", runner-up paths differ
    v, blank = 3, 2
    log_probs = np.full((1, 4, v), -5.0, np.float32)
    for t, c in enumerate([0, blank, 1, blank]):
        log_probs[0, t, c] = 0.0
    got = nbest.nbest_from_logits(log_probs, np.array([4]), num_paths=3)
    ref = ref_nbest.nbest_from_logits(log_probs, np.array([4]), num_paths=3)
    assert got == ref
    assert got[0][0] == [0, 1]
    labels, lengths, distances = nbest.combine_label_nbest(got, [[0, 1]])
    for a, b in zip((labels, lengths, distances),
                    ref_nbest.combine_label_nbest(ref, [[0, 1]])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(labels[0, 0, :2], [0, 1])
    assert distances[0, 0] == 0.0
    assert distances[0, 1] == 0.0  # best hyp == ref
    assert (distances[0, 2:] > 0).all()


def collapse(path, blank):
    out, prev = [], blank
    for p in path:
        if p != blank and p != prev:
            out.append(p)
        prev = p
    return out


@pytest.mark.parametrize("labels, frames, blank", [
    ([3, 4], 6, 9), ([5, 5], 6, 9), ([1, 2, 2], 4, 0)])
def test_fill_blank_path_matches_reference(labels, frames, blank):
    path = nbest.fill_blank_path(labels, num_frames=frames, blank_id=blank)
    assert path == ref_nbest.fill_blank_path(labels, num_frames=frames,
                                             blank_id=blank)
    assert len(path) == frames
    assert collapse(path, blank) == labels


def test_fill_blank_path_round_trips_like_reference():
    rng = np.random.RandomState(2)
    for _ in range(50):
        u = rng.randint(1, 8)
        labs = [int(x) for x in rng.randint(1, 4, u)]
        repeats = sum(1 for i in range(1, u) if labs[i] == labs[i - 1])
        frames = u + repeats + rng.randint(0, 6)
        path = nbest.fill_blank_path(labs, frames, blank_id=0)
        assert path == ref_nbest.fill_blank_path(labs, frames, blank_id=0)
        assert len(path) == frames
        assert collapse(path, 0) == labs
    for labs, frames in (([1, 1], 2), ([1, 1, 1], 4)):
        with pytest.raises(ValueError):
            nbest.fill_blank_path(labs, frames, blank_id=0)
        with pytest.raises(ValueError):
            ref_nbest.fill_blank_path(labs, frames, blank_id=0)


def test_is_token_and_exports():
    assert kaldi.is_token("utt_001")
    assert not kaldi.is_token("")
    assert not kaldi.is_token("a b")
    for name in ("NnetExample", "NnetIo", "read_nnet_example", "Nnet1Model",
                 "FloatVectorRandomizer", "Int32VectorRandomizer",
                 "MatrixRandomizer", "NnetDataRandomizerOptions",
                 "RandomizerMask"):
        assert hasattr(kaldi, name) and hasattr(ref_kaldi, name), name
