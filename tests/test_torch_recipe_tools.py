"""The port's data tools and the recipe shim on the CPU.

Each data tool of ``lstm_ctc_tpu_torch.bin`` (feature extraction, CMVN,
feature tables, int vectors, label counts, records, the LM and the CTC
token FST) runs in this process through its ``main(argv)``, and its
``bin/`` counterpart runs on the same inputs in one subprocess that loads
the JAX package once (each ``bin/`` script through ``runpy`` under its own
``sys.argv`` and standard streams).  Every archive, scp, shard, ARPA and
FST text they write must be byte-equal; each side runs in its own
directory with the same relative output names, so scp lines match.  The
cases cover the pipe forms (``ark:-`` in and out, ``ark:cmd |``),
``--spk2utt`` / ``--utt2spk`` CMVN, ``select-feats`` ranges, ``train-lm``
at orders 2 and 3 (native and Python counting) and ``ctc-token-fst``.

The shim (``lstm_ctc_tpu_torch/recipe_python.py``): every ``bin/*.py`` is
mapped, passed through or refused; a mapped tool runs in a subprocess whose
``sitecustomize`` blocks ``jax`` and ``lstm_ctc_tpu``; an unmapped
``bin/`` tool is refused with exit code 2; with no script the shim is
``python3``.  A data tool starts without importing torch.
"""

import contextlib
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from lstm_ctc_tpu_torch import _native
from lstm_ctc_tpu_torch import recipe_python as shim
from lstm_ctc_tpu_torch.host import kaldi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
SHIM = os.path.join(REPO, "lstm_ctc_tpu_torch", "recipe_python.py")
BLOCKER = """import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "lstm_ctc_tpu"):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, _Block())
"""


def write_wav(path, samples, rate=16000):
    data = np.asarray(samples, "<i2").tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, 2 * rate,
                                       2, 16))
        fh.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Inputs from a numpy seed: 3 wavs, 5 feature matrices of 6 columns
    (two speakers), their CMVN stats, int-vector labels (binary and text),
    LM text and a tokens table."""
    root = tmp_path_factory.mktemp("tools")
    inp = root / "in"
    inp.mkdir()
    rng = np.random.RandomState(12)
    lines = []
    for i in range(3):
        t = np.arange(4000 + 800 * i) / 16000.0
        wave = 3000 * np.sin(2 * np.pi * (300 + 150 * i) * t) \
            + 300 * rng.randn(t.size)
        write_wav(str(inp / ("w%d.wav" % i)), wave)
        lines.append("w%d %s\n" % (i, inp / ("w%d.wav" % i)))
    (inp / "wav.scp").write_text("".join(lines))
    (inp / "fbank.conf").write_text("--num-mel-bins=12\n--dither=0.5\n"
                                    "# a comment\n--seed=3\n")
    keys = ["a1", "a2", "b1", "b2", "b3"]
    feats = {k: (rng.randn(rng.randint(9, 30), 6) * 2 + 1).astype(np.float32)
             for k in keys}
    with kaldi.TableWriter("ark:%s" % (inp / "feats.ark"), "matrix") as w:
        for k in keys:
            w.Write(k, feats[k])
    (inp / "spk2utt").write_text("A a1 a2\nB b1 b2 b3\n")
    (inp / "utt2spk").write_text("".join("%s %s\n" % (k, k[0].upper())
                                         for k in keys))
    from lstm_ctc_tpu_torch.host.data.features import accumulate_cmvn_stats
    with kaldi.TableWriter("ark:%s" % (inp / "cmvn.ark"),
                           "matrix_double") as w:
        for spk, utts in (("A", keys[:2]), ("B", keys[2:])):
            stats = None
            for k in utts:
                stats = accumulate_cmvn_stats(feats[k], stats)
            w.Write(spk, stats)
    stats = None
    for k in keys:
        stats = accumulate_cmvn_stats(feats[k], stats)
    with kaldi.Output(str(inp / "cmvn.mat"), binary=True) as out:
        kaldi.write_matrix(out.stream(), True, stats, double=True)
    labels = {k: rng.randint(1, 9, size=rng.randint(1, 6)).astype(np.int32)
              for k in keys}
    labels["b3"] = np.arange(1, 40, dtype=np.int32)   # longer than b3
    with kaldi.TableWriter("ark:%s" % (inp / "labels.ark"), "int32vec") as w:
        for k in keys[1:]:   # a1 has no labels
            w.Write(k, labels[k])
    (inp / "labels.txt").write_text("".join(
        "%s %s\n" % (k, " ".join(str(v) for v in labels[k])) for k in keys))
    words = ["ka", "mi", "to", "sa", "ne", "ru"]
    (inp / "text").write_text("".join(
        "u%d %s\n" % (i, " ".join(rng.choice(words, rng.randint(1, 6))))
        for i in range(30)))
    (inp / "tokens.txt").write_text(
        "<eps> 0\n<blk> 1\na 2\nb 3\nc 4\n#0 5\n#1 6\n")
    return root


def i(name):
    return "{in}/" + name


# name -> (bin tool, arguments, stdin file or None, outputs to compare,
#          environment)
CASES = {
    "fbank": ("compute-fbank-feats",
              ["--num-mel-bins=10", "--dither=0.5", "--seed=7",
               "scp:" + i("wav.scp"), "ark,scp:fbank.ark,fbank.scp"],
              None, ["fbank.ark", "fbank.scp"], {}),
    "fbank-config": ("compute-fbank-feats",
                     ["--config=" + i("fbank.conf"), "--snip-edges=false",
                      "scp:" + i("wav.scp"), "ark,t:fbank.txt"],
                     None, ["fbank.txt"], {}),
    "cmvn-spk2utt": ("compute-cmvn-stats",
                     ["--spk2utt=ark:" + i("spk2utt"), "ark:" + i("feats.ark"),
                      "ark,scp:cmvn.ark,cmvn.scp"],
                     None, ["cmvn.ark", "cmvn.scp"], {}),
    "cmvn-global": ("compute-cmvn-stats", ["ark:" + i("feats.ark"),
                                           "cmvn.mat"],
                    None, ["cmvn.mat"], {}),
    "cmvn-per-utt": ("compute-cmvn-stats",
                     ["--per-utt=true", "ark:-", "ark,t:cmvn.txt"],
                     "feats.ark", ["cmvn.txt"], {}),
    "apply-cmvn-utt2spk": ("apply-cmvn",
                           ["--norm-vars=true", "--utt2spk=ark:" + i("utt2spk"),
                            "ark:" + i("cmvn.ark"), "ark:" + i("feats.ark"),
                            "ark:out.ark"],
                           None, ["out.ark"], {}),
    "apply-cmvn-global-pipe": ("apply-cmvn",
                               ["--norm-means=true", "--norm-vars=false",
                                i("cmvn.mat"),
                                "ark:cat " + i("feats.ark") + " |", "ark:-"],
                               None, ["<stdout>"], {}),
    "add-deltas-pipe": ("add-deltas", ["--delta-order=2", "ark:-", "ark:-"],
                        "feats.ark", ["<stdout>"], {}),
    "splice": ("splice-feats", ["--left-context=2", "--right-context=1",
                                "ark:" + i("feats.ark"), "ark:out.ark"],
               None, ["out.ark"], {}),
    "subsample": ("subsample-feats", ["--n=3", "ark:" + i("feats.ark"),
                                      "ark,t:out.txt"],
                  None, ["out.txt"], {}),
    "copy-feats-scp": ("copy-feats", ["ark:" + i("feats.ark"),
                                      "ark,scp:out.ark,out.scp"],
                       None, ["out.ark", "out.scp"], {}),
    "copy-feats-compress": ("copy-feats", ["--compress=true", "ark:-",
                                           "ark:out.ark"],
                            "feats.ark", ["out.ark"], {}),
    "select-ranges": ("select-feats", ["5,0-4", "ark:-", "ark:-"],
                      "feats.ark", ["<stdout>"], {}),
    "select-repeat": ("select-feats", ["2-3,0,5,5", "ark:" + i("feats.ark"),
                                       "ark,t:out.txt"],
                      None, ["out.txt"], {}),
    "copy-int-vector-text": ("copy-int-vector",
                             ["ark:-", "ark,scp:labels.ark,labels.scp"],
                             "labels.txt", ["labels.ark", "labels.scp"], {}),
    "feat-to-dim": ("feat-to-dim", ["ark:" + i("feats.ark"), "-"],
                    None, ["<stdout>"], {}),
    "feat-to-len": ("feat-to-len", ["ark:" + i("feats.ark")],
                    None, ["<stdout>"], {}),
    "feat-to-len-file": ("feat-to-len", ["ark:" + i("feats.ark"), "lens"],
                         None, ["lens"], {}),
    "analyze-counts": ("analyze-counts", ["--counts-dim=12", "ark:-",
                                          "counts"],
                       "labels.txt", ["counts"], {}),
    "records": ("convert-to-records",
                ["--nnet-target", "ark:" + i("labels.ark"),
                 "--target-length-cutoff", "1", "ark:" + i("feats.ark"),
                 "rec", "rec/records.scp"],
                None, ["rec/records.rec", "rec/records.scp"], {}),
    "tfrecords-pipe": ("convert-to-tfrecords",
                       ["--shard-name", "s0",
                        "ark:cat " + i("feats.ark") + " |", "rec",
                        "rec/all.scp"],
                       None, ["rec/s0.rec", "rec/all.scp"], {}),
    "lm-order2": ("train-lm", ["--order", "2", i("text")], None,
                  ["<stdout>"], {}),
    "lm-order3-stdin": ("train-lm", ["--order", "3", "-"], "text",
                        ["<stdout>"], {}),
    "lm-order3-python-counts": ("train-lm", ["--order", "3", i("text")],
                                None, ["<stdout>"],
                                {"LSTM_CTC_TPU_NATIVE_COUNTS": "0"}),
    "token-fst": ("ctc-token-fst", [i("tokens.txt")], None, ["<stdout>"],
                  {}),
}

BIN_RUNNER = r"""
import io, json, os, runpy, sys
jobs = json.load(open(sys.argv[1]))
for job in jobs:
    os.makedirs(job["cwd"], exist_ok=True)
    os.chdir(job["cwd"])
    env = dict(os.environ)
    os.environ.update(job["env"])
    stdin, stdout = sys.stdin, sys.stdout
    src = open(job["stdin"], "rb") if job["stdin"] else io.BytesIO()
    sink = open("stdout.bin", "wb")
    sys.stdin = io.TextIOWrapper(src, encoding="utf-8")
    sys.stdout = io.TextIOWrapper(sink, encoding="utf-8")
    sys.argv = [job["script"]] + job["args"]
    try:
        runpy.run_path(job["script"], run_name="__main__")
    except SystemExit as exc:
        assert not exc.code, (job, exc.code)
    finally:
        sys.stdout.flush()
        sys.stdin, sys.stdout = stdin, stdout
        src.close()
        sink.close()
        os.environ.clear()
        os.environ.update(env)
print("OK")
"""


def expand(args, corpus):
    return [a.replace("{in}", str(corpus / "in")) for a in args]


@pytest.fixture(scope="module")
def bin_outputs(corpus):
    """Every case through its ``bin/`` tool, in one subprocess."""
    jobs = []
    for name, (tool, args, stdin, _, env) in CASES.items():
        jobs.append({"cwd": str(corpus / "bin" / name),
                     "script": os.path.join(BIN, tool + ".py"),
                     "args": expand(args, corpus),
                     "stdin": str(corpus / "in" / stdin) if stdin else None,
                     "env": env})
    spec = corpus / "jobs.json"
    spec.write_text(json.dumps(jobs))
    proc = subprocess.run([sys.executable, "-c", BIN_RUNNER, str(spec)],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    return corpus / "bin"


@pytest.fixture(scope="module")
def native_counter():
    """The port's count-ngrams, as a recipe run builds it."""
    _native.ensure_built(["count-ngrams"])


def run_port(module, argv, cwd, stdin=None, env=None, monkeypatch=None):
    """A port tool's ``main(argv)`` in this process with its own working
    directory and standard streams; returns its standard output's bytes."""
    import importlib
    tool = importlib.import_module("lstm_ctc_tpu_torch.bin." + module)
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    src = open(stdin, "rb") if stdin else io.BytesIO()
    sink = io.BytesIO()
    out = io.TextIOWrapper(sink, encoding="utf-8")
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(src, encoding="utf-8"))
    with contextlib.redirect_stdout(out):
        try:
            tool.main(argv)
        finally:
            out.flush()
            src.close()
    return sink.getvalue()


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_tool_is_byte_equal_to_bin(corpus, bin_outputs, native_counter,
                                        monkeypatch, name):
    tool, args, stdin, outputs, env = CASES[name]
    cwd = corpus / "port" / name
    stdout = run_port(shim.TOOLS[tool], expand(args, corpus), str(cwd),
                      str(corpus / "in" / stdin) if stdin else None, env,
                      monkeypatch)
    ref_dir = bin_outputs / name
    for out in outputs:
        got = stdout if out == "<stdout>" else (cwd / out).read_bytes()
        want = (ref_dir / ("stdout.bin" if out == "<stdout>" else out)) \
            .read_bytes()
        assert got, (name, out)
        assert got == want, (name, out)


def test_every_bin_tool_is_mapped_passed_or_refused(tmp_path):
    """The shim's table covers ``bin/``: each script is mapped to a port
    module that exists, or passed through (it imports no package); an
    unknown ``bin/`` name is refused; a script outside ``bin/`` passes."""
    import importlib
    names = sorted(f[:-3] for f in os.listdir(BIN) if f.endswith(".py"))
    assert set(names) == set(shim.TOOLS) | set(shim.PASS_THROUGH)
    for name in names:
        module = shim.route(os.path.join(BIN, name + ".py"))
        if name in shim.PASS_THROUGH:
            assert module is None
            text = open(os.path.join(BIN, name + ".py")).read()
            assert "lstm_ctc_tpu" not in text and "jax" not in text
        else:
            assert hasattr(importlib.import_module(
                "lstm_ctc_tpu_torch.bin." + module), "main")
    with pytest.raises(shim.Refused, match="no port entry point"):
        shim.route(os.path.join(BIN, "nnet-something.py"))
    outside = tmp_path / "tool.py"
    outside.write_text("")
    assert shim.route(str(outside)) is None
    assert set(shim.MODEL_TOOLS) <= set(shim.TOOLS)


@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu", "x.py", "a"], ("cpu", ["x.py", "a"])),
    (["--device=cuda:1", "x.py"], ("cuda:1", ["x.py"])),
    (["x.py", "--device", "cpu"], (None, ["x.py", "--device", "cpu"])),
    ([], (None, []))])
def test_shim_options(argv, want):
    assert shim.parse_shim_options(argv) == want


def test_shim_passes_device_to_model_tools_only():
    nnet = os.path.join(BIN, "nnet-forward.py")
    feats = os.path.join(BIN, "copy-feats.py")
    assert shim.tool_argv(nnet, ["a"], "cpu") == ["a", "--device", "cpu"]
    assert shim.tool_argv(nnet, ["a"], None) == ["a"]
    assert shim.tool_argv(feats, ["a"], "cpu") == ["a"]


def blocked_env(tmp_path):
    block = tmp_path / "block"
    block.mkdir(exist_ok=True)
    (block / "sitecustomize.py").write_text(BLOCKER)
    return dict(os.environ, PYTHONPATH=str(block))


def test_shim_runs_a_mapped_tool_without_jax(corpus, bin_outputs, tmp_path):
    """The recipe's own pipe form through the shim in a subprocess where
    ``jax`` and ``lstm_ctc_tpu`` cannot be imported: the same bytes as
    ``bin/``."""
    env = blocked_env(tmp_path)
    feats = str(corpus / "in" / "feats.ark")
    proc = subprocess.run(
        [sys.executable, SHIM, "--device", "cpu",
         os.path.join(BIN, "select-feats.py"), "5,0-4", "ark:-", "ark:-"],
        stdin=open(feats, "rb"), capture_output=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stdout == (bin_outputs / "select-ranges" / "stdout.bin") \
        .read_bytes()
    probe = subprocess.run(
        [sys.executable, "-c", "import jax"], capture_output=True, env=env,
        timeout=60)
    assert probe.returncode != 0 and b"blocked: jax" in probe.stderr


def test_shim_refuses_unmapped_bin_tools(tmp_path):
    proc = subprocess.run(
        [sys.executable, SHIM, os.path.join(BIN, "nnet-something.py")],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "no port entry point" in proc.stderr


def test_shim_without_a_script_is_python(tmp_path):
    """No script: the interpreter (-c); a script outside ``bin/`` runs as
    ``python3`` would run it, with its arguments."""
    proc = subprocess.run([sys.executable, SHIM, "-c", "print(6 * 7)"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout == "42\n"
    script = tmp_path / "echo.py"
    script.write_text("import sys\nprint(sys.argv[1:], sys.path[0])\n")
    proc = subprocess.run([sys.executable, SHIM, "--device", "cpu",
                           str(script), "a", "--device", "b"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0
    assert proc.stdout == "%s %s\n" % (["a", "--device", "b"], tmp_path)


def test_data_tools_start_without_torch(corpus, tmp_path):
    """A data tool imports neither torch nor the models (one decode job
    pipes several of them)."""
    script = (
        "import sys\n"
        "from lstm_ctc_tpu_torch.bin import copy_feats\n"
        "copy_feats.main(sys.argv[1:])\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] == 'torch'\n"
        "               or m.startswith('lstm_ctc_tpu_torch.models'))\n"
        "assert not heavy, heavy[:5]\n"
        "print('OK')\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, "ark:" + str(corpus / "in" /
                                                    "feats.ark"),
         "ark:" + str(tmp_path / "copy.ark")],
        capture_output=True, text=True, cwd=REPO, timeout=60,
        env=blocked_env(tmp_path))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
