"""The synthetic recipe end to end on the port, on the CPU.

``egs/synthetic/run.sh`` stages 0-5 (data, LM, TLG graph, fbank + CMVN,
labels + records, training through ``scripts/train_oplr.sh``, lattice
decode + WER) with ``PYTHON`` set to the port's shim
(``lstm_ctc_tpu_torch/recipe_python.py --device cpu``), ``FSTBIN`` and
``PATH`` to the native tools that ``lstm_ctc_tpu_torch/_native.py`` builds
into a temporary directory, and a ``sitecustomize`` on ``PYTHONPATH``
that blocks ``jax`` and ``lstm_ctc_tpu`` in every process of the recipe.
At tiny widths it must reach its WER summary, every model tool must log
the device it ran on, and no log may hold a warning.  Stages 0 and 2-3
run once more with the plain ``python3`` through ``bin/`` (the JAX
package's tools), at the same time; every file those stages wrote (the
LM, the features, CMVN stats, labels, record shards, scps and label
counts) must be byte-equal to the shim run's, the work directory's path
aside.
"""

import os
import re
import subprocess
import sys

from lstm_ctc_tpu_torch import _native
from test_torch_recipe_tools import BLOCKER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "egs", "synthetic", "run.sh")
SHIM = os.path.join(REPO, "lstm_ctc_tpu_torch", "recipe_python.py")
TINY = ["--num-layers", "1", "--num-neurons", "16", "--num-projects", "8",
        "--num-experts", "2", "--num-train", "16", "--max-iter", "1",
        "--min-iters", "1"]


def files_under(root):
    out = []
    for base, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".log"):
                out.append(os.path.relpath(os.path.join(base, name), root))
    return sorted(out)


def test_recipe_through_the_shim_matches_bin(tmp_path):
    plain_work, port_work = tmp_path / "plain", tmp_path / "port"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    plain = subprocess.Popen(
        ["bash", "-c", 'bash "$0" "$@" --stop-stage 0 && '
         'bash "$0" "$@" --stage 2 --stop-stage 3',
         RUN, "--work", str(plain_work)] + TINY,
        env=dict(env, PYTHON=sys.executable), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=REPO)
    try:
        native = _native.ensure_built(build_dir=str(tmp_path / "native"))
        block = tmp_path / "block"
        block.mkdir()
        (block / "sitecustomize.py").write_text(BLOCKER)
        port = subprocess.run(
            ["bash", RUN, "--work", str(port_work), "--stop-stage", "5"]
            + TINY, capture_output=True, text=True, cwd=REPO, timeout=600,
            env=dict(env, PYTHONPATH=str(block), FSTBIN=native["dir"],
                     PATH=native["dir"] + os.pathsep + env["PATH"],
                     PYTHON="%s %s --device cpu" % (sys.executable, SHIM)))
        plain_out, _ = plain.communicate(timeout=600)
    finally:
        if plain.poll() is None:
            plain.kill()
    assert port.returncode == 0, (port.stdout[-3000:], port.stderr[-3000:])
    assert re.search(r"best WER =====\n\S+summary \d+\.\d+", port.stdout), \
        port.stdout[-2000:]
    assert plain.returncode == 0, plain_out.decode()[-3000:]

    exp = port_work / "exp"
    model_logs = sorted(p for p in exp.glob("nnet.*.log"))
    assert len(model_logs) == 3   # init + CV, one epoch of train and CV
    for log in model_logs + [exp / "decode_test" / "forward.log"]:
        text = log.read_text()
        assert "INFO:tensorflow:device cpu" in text, log
    for base, _, names in os.walk(port_work):
        for name in names:
            if name.endswith(".log"):
                text = open(os.path.join(base, name)).read()
                assert "Warning" not in text, (name, text[-1000:])

    written = files_under(plain_work)
    assert "data/lm.arpa" in written and "exp/label.counts" in written
    assert "records/train/tfrecords.scp" in written
    assert any(f.endswith(".rec") for f in written)
    for rel in written:
        want = (plain_work / rel).read_bytes().replace(
            str(plain_work).encode(), b"WORK")
        got = (port_work / rel).read_bytes().replace(
            str(port_work).encode(), b"WORK")
        assert got == want, rel
