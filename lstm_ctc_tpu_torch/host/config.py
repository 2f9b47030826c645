"""nnet.config parsing — the ``key = value`` typed config file.

Contract (reference nnet/config.py:40-63): one entry per line; lines starting
with '#' are skipped; inline '#' tokens are stripped; the key is the first
token and the value the *last* remaining token (so ``key = value`` and
``key value`` both parse).  Values are typed by parse attempt in the order
int → float → bool("true"/"false", case-insensitive) → str.

The recipe writes these keys (reference egs/wsj/run_wsj_phn.sh:226-243):
nnet_type, input_dim, left_context, right_context, subsample, num_layers,
num_neurons, num_projects, num_targets, use_peepholes, use_bn, dropout_rate,
num_experts, moe_temp, uniform_label_sm, prior_label_sm, prior_label_path,
seed.
"""

from __future__ import annotations

from typing import Dict, Union

ConfigValue = Union[int, float, bool, str]


def coerce(text: str) -> ConfigValue:
    """One value typed as nnet.config types it."""
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    lowered = text.lower()
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    return text


def parse_config(path: str) -> Dict[str, ConfigValue]:
    config: Dict[str, ConfigValue] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = [t for t in line.split() if not t.startswith("#")]
            if not tokens:
                continue
            config[tokens[0]] = coerce(tokens[-1])
    return config


def format_config(config: Dict[str, ConfigValue]) -> str:
    """Render a config dict back to the on-disk ``key = value`` format."""
    lines = []
    for key in sorted(config):
        val = config[key]
        if isinstance(val, bool):
            val = "true" if val else "false"
        lines.append("%s = %s" % (key, val))
    return "\n".join(lines) + "\n"
