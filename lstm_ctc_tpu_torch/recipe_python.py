"""A ``PYTHON`` for the shipped shell recipes that runs them on the port.

Every recipe script (``egs/*/run.sh``, ``scripts/*.sh``) runs its Python
tools as ``$PYTHON "$BIN/<tool>.py" args``, with ``BIN`` the repository's
``bin/``.  With

    PYTHON="python3 <repo>/lstm_ctc_tpu_torch/recipe_python.py [--device cuda|cpu]"

each ``<repo>/bin/<tool>.py args`` runs the port's module for that tool
(``lstm_ctc_tpu_torch.bin.<tool_with_underscores>``, in this process,
with the same arguments), and the model tools (``nnet-init``,
``nnet-train``, ``nnet-validate``, ``nnet-forward``, ``nnet-train-loop``,
``nnet-decode``) also get ``--device`` when one is given (their default
is ``cuda``).  The scripts that import no package (``compute-wer``,
``prep-ctc-trans``, ``reorder-posterior``) and any script outside
``bin/`` (``egs/synthetic/local/gen_data.py``) run as ``python3`` would
run them.  A ``bin/`` tool with no mapping is refused with an error: the
shim never runs a script of the JAX package.  With no script argument it
behaves as ``python3``.

    python3 lstm_ctc_tpu_torch/recipe_python.py --device cuda bin/copy-feats.py ark:a.ark ark:b.ark

The native tools of the graph, lattice and scoring stages come from
``lstm_ctc_tpu_torch/_native.py`` (``FSTBIN`` and ``PATH``).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN_DIR = os.path.join(REPO, "bin")
# bin/<tool>.py -> lstm_ctc_tpu_torch.bin.<module>
TOOLS = {
    "add-deltas": "add_deltas",
    "analyze-counts": "analyze_counts",
    "apply-cmvn": "apply_cmvn",
    "compute-cmvn-stats": "compute_cmvn_stats",
    "compute-fbank-feats": "compute_fbank_feats",
    "convert-to-records": "convert_to_records",
    # a byte-identical copy of convert-to-records.py
    "convert-to-tfrecords": "convert_to_records",
    "copy-feats": "copy_feats",
    "copy-int-vector": "copy_int_vector",
    "ctc-token-fst": "ctc_token_fst",
    "feat-to-dim": "feat_to_dim",
    "feat-to-len": "feat_to_len",
    "nnet-decode": "nnet_decode",
    "nnet-forward": "nnet_forward",
    "nnet-init": "nnet_init",
    "nnet-train": "nnet_train",
    "nnet-train-loop": "nnet_train_loop",
    "nnet-validate": "nnet_validate",
    "select-feats": "select_feats",
    "splice-feats": "splice_feats",
    "subsample-feats": "subsample_feats",
    "train-lm": "train_lm",
}
# the tools that take --device
MODEL_TOOLS = ("nnet-decode", "nnet-forward", "nnet-init", "nnet-train",
               "nnet-train-loop", "nnet-validate")
# bin/ scripts that import no package: run as they are
PASS_THROUGH = ("compute-wer", "prep-ctc-trans", "reorder-posterior")


class Refused(Exception):
    """A ``bin/`` tool the shim has no mapping for."""


def parse_shim_options(argv):
    """(device or None, the rest): ``--device X`` or ``--device=X`` before
    the script."""
    device, rest = None, list(argv)
    if rest and rest[0].startswith("--device="):
        device, rest = rest[0].split("=", 1)[1], rest[1:]
    elif rest and rest[0] == "--device":
        if len(rest) < 2:
            raise SystemExit("recipe_python: --device needs a value")
        device, rest = rest[1], rest[2:]
    return device, rest


def route(script):
    """The port module's name for ``script``, or None to run it as
    ``python3`` would; raises ``Refused`` for an unmapped ``bin/`` tool."""
    path = os.path.realpath(script)
    if os.path.dirname(path) != os.path.realpath(BIN_DIR):
        return None
    name = os.path.basename(path)
    tool = name[:-3] if name.endswith(".py") else name
    if tool in TOOLS:
        return TOOLS[tool]
    if tool in PASS_THROUGH:
        return None
    raise Refused("recipe_python: bin/%s has no port entry point; it is "
                  "refused rather than run on the JAX package" % name)


def tool_argv(script, args, device):
    """The port tool's arguments: the script's, plus ``--device`` for the
    model tools when the shim was given one."""
    tool = os.path.basename(script)
    tool = tool[:-3] if tool.endswith(".py") else tool
    if device is not None and tool in MODEL_TOOLS:
        return list(args) + ["--device", device]
    return list(args)


def main(argv=None):
    device, rest = parse_shim_options(sys.argv[1:] if argv is None
                                      else argv)
    if not rest or rest[0].startswith("-"):
        # no script: the interpreter itself (-c, -m, stdin)
        os.execv(sys.executable, [sys.executable] + rest)
    script, args = rest[0], rest[1:]
    try:
        module = route(script)
    except Refused as exc:
        print(exc, file=sys.stderr)
        sys.exit(2)
    if module is None:
        os.execv(sys.executable, [sys.executable, script] + args)
    # the package's parent instead of this file's directory, which would
    # put the package's own modules on the top level
    sys.path[0] = REPO
    import importlib
    tool = importlib.import_module("lstm_ctc_tpu_torch.bin." + module)
    sys.argv = [script] + args
    tool.main(tool_argv(script, args, device))
    sys.exit(0)


if __name__ == "__main__":
    main()
