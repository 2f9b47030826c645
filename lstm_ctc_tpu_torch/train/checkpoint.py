"""Checkpoints in the reference's ``.npz`` layout, and the numpy bridge.

Keys are the '/'-joined paths of the nested dict/list parameter tree under
``params/``, ``state/`` and ``extra/`` (reference
``lstm_ctc_tpu/train/checkpoint.py``), e.g. ``params/fwd/0/wx``.  A
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves_with_path(tree, prefix=()):
    """(checkpoint key, leaf) for every leaf of a nested dict/list tree, in
    a fixed order (sorted keys); the key is the '/'-joined path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def params_to_numpy(tree):
    """Tensor tree → numpy tree (same structure)."""
    return tree_map(_to_numpy, tree)


def params_from_numpy(tree, device="cpu"):
    """Numpy tree (e.g. the reference package's parameters passed through
    ``np.asarray``) → tensor tree on ``device``, dtypes kept."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in leaves_with_path(tree):
        if key in flat:
            raise ValueError("duplicate checkpoint key %s" % key)
        flat[key] = _to_numpy(leaf)
    return flat


def unflatten_into(template, flat: Dict[str, np.ndarray]):
    """Fill a template tree with stored arrays, validating shapes.  Each
    leaf lands on its template leaf's device with the stored dtype."""
    keys = {key for key, _ in leaves_with_path(template)}
    extra = set(flat) - keys
    if extra:
        raise KeyError("checkpoint has unexpected parameters: %s"
                       % sorted(extra)[:5])

    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError("checkpoint missing parameter %r" % key)
        value = flat[key]
        if tuple(node.shape) != tuple(value.shape):
            raise ValueError("checkpoint shape mismatch for %r: %s vs %s"
                             % (key, tuple(node.shape), value.shape))
        return torch.from_numpy(np.array(value)).to(node.device)

    return fill(template, ())


def save_checkpoint(path: str, params, net_state=None, extra=None) -> None:
    arrays = {"params/" + k: v for k, v in flatten_tree(params).items()}
    if net_state:
        arrays.update({"state/" + k: v
                       for k, v in flatten_tree(net_state).items()})
    if extra:
        arrays.update({"extra/" + k: np.asarray(v)
                       for k, v in extra.items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, params_template,
                    state_template=None) -> Tuple[Any, Any, Dict]:
    with np.load(path, allow_pickle=False) as data:
        stored = {k: data[k] for k in data.files}

    def section(name):
        return {k[len(name) + 1:]: v for k, v in stored.items()
                if k.startswith(name + "/")}

    params = unflatten_into(params_template, section("params"))
    net_state = state_template
    state_flat = section("state")
    if state_template is not None and state_flat:
        net_state = unflatten_into(state_template, state_flat)
    return params, net_state, section("extra")
