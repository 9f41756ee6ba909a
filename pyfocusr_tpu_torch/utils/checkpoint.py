"""Results saved to and loaded from one self-describing ``.npz`` file.

Counterpart of ``save_results`` and ``load_results`` in
``pyfocusr_tpu/utils/checkpoint.py:30-49``, without jax: a nested
dict / list / tuple of arrays or tensors is flattened in the order and
under the path strings that ``jax.tree_util.tree_flatten_with_path`` gives
(dict keys sorted, ``['key']`` for a dict entry, ``[i]`` for a sequence
element, joined by ``/``: ``['lams']``, ``['w']/[0]``), and written as
``__keys__`` plus ``leaf_i``.  Files written by either package load in the
other.

``StageCheckpointer`` (:52-155, with ``_attr_from_path`` :171) keeps one
fingerprinted ``<dir>/<stage>.npz`` a stage, in that layout; the
multi-resolution path (``multires.register_pair_multires``) resumes from it.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

__all__ = ["save_results", "load_results", "StageCheckpointer"]


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


_PYTREE_KEY_RE = re.compile(r"^\[['\"](.+)['\"]\]$")


def _attr_from_path(name: str) -> str:
    """The dict key a flattened path (``"['Q']"``) or a bare name denotes."""
    leaf = name.rsplit("/", 1)[-1]
    m = _PYTREE_KEY_RE.match(leaf)
    return m.group(1) if m else leaf


class StageCheckpointer:
    """Fingerprinted stage store for long multi-stage runs: one
    ``<dir>/<stage>.npz`` a stage, a flat dict of arrays (or one array)
    plus the run's fingerprint, a hash of every input that determines the
    stage's outputs.

    ``load(stage)`` returns the saved value when the file exists, reads and
    carries this run's fingerprint, else None (a stale, torn or missing
    file is a miss).  Its leaves come back as tensors on ``device``, in the
    dtypes they were saved in.  ``save`` writes atomically (a temporary
    file, then ``os.replace``).  ``get_or(stage, fn)`` loads or computes,
    saves and returns.  ``loaded`` lists the stages served from disk."""

    def __init__(self, directory: str, fingerprint: str, device="cpu"):
        self.dir = directory
        self.fingerprint = str(fingerprint)
        self.device = torch.device(device)
        os.makedirs(directory, exist_ok=True)
        self.loaded: list = []

    def _path(self, stage: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", stage):
            raise ValueError(f"invalid checkpoint stage name {stage!r}")
        return os.path.join(self.dir, f"{stage}.npz")

    def load(self, stage: str):
        path = self._path(stage)
        if not os.path.exists(path):
            return None
        try:
            flat = {_attr_from_path(k): v for k, v in load_results(path).items()}
        except Exception:
            return None
        # The fingerprint first: a stale file costs a header read, not an
        # upload of arrays about to be discarded.
        if str(flat.pop("__fingerprint__", None)) != self.fingerprint:
            return None
        out = {k: torch.from_numpy(np.array(v)).to(self.device)
               for k, v in flat.items()}
        self.loaded.append(stage)
        if set(out) == {"__value__"}:
            return out["__value__"]
        return out

    def save(self, stage: str, tree) -> None:
        tree = dict(tree) if isinstance(tree, dict) else {"__value__": tree}
        tree["__fingerprint__"] = np.array(self.fingerprint)
        path = self._path(stage)
        # The suffix ends in ".npz": np.savez appends it otherwise and the
        # rename would promote the empty temporary file.
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp.npz")
        os.close(fd)
        try:
            save_results(tmp, tree)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get_or(self, stage: str, fn):
        val = self.load(stage)
        if val is None:
            val = fn()
            self.save(stage, val)
        return val
