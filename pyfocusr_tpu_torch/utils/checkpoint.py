"""Results saved to and loaded from one self-describing ``.npz`` file.

Counterpart of ``save_results`` and ``load_results`` in
``pyfocusr_tpu/utils/checkpoint.py:30-49``, without jax: a nested
dict / list / tuple of arrays or tensors is flattened in the order and
under the path strings that ``jax.tree_util.tree_flatten_with_path`` gives
(dict keys sorted, ``['key']`` for a dict entry, ``[i]`` for a sequence
element, joined by ``/``: ``['lams']``, ``['w']/[0]``), and written as
``__keys__`` plus ``leaf_i``.  Files written by either package load in the
other.  ``StageCheckpointer`` is not ported (it serves the multi-resolution
path, which the port does not have yet).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_results", "load_results"]


def _flatten(tree, prefix, out):
    if tree is None:
        return  # an empty subtree, as in jax
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], prefix + [f"[{key!r}]"], out)
    elif isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            _flatten(leaf, prefix + [f"[{i}]"], out)
    else:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu().numpy()
        out.append(("/".join(prefix), np.asarray(tree)))


def save_results(path: str, tree) -> None:
    """Serialize a nested dict / list / tuple of arrays (numpy or torch)
    to ``.npz``, self-describing by its flattened paths."""
    leaves = []
    _flatten(tree, [], leaves)
    np.savez_compressed(
        path,
        __keys__=np.array([k for k, _ in leaves]),
        **{f"leaf_{i}": v for i, (_, v) in enumerate(leaves)},
    )


def load_results(path: str) -> dict:
    """A file of :func:`save_results` as a flat {path: numpy array} dict."""
    with np.load(path, allow_pickle=False) as data:
        keys = [str(k) for k in data["__keys__"]]
        return {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}
