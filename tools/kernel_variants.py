"""Copies of a kernel source with constants or text edited, built as their own
libraries: the shared part of ``tools/knn_variants.py`` and
``tools/cpd_estep_variants.py``.  Their timing and the card's name line come
from ``chip_smoke.py`` (``graph_ms``, ``nvidia_smi_line``).

A variant ``spec`` is either comma-separated ``NAME=VALUE`` pairs, each
replacing ``constexpr int NAME = ...;``, literal replacements ``OLD=>NEW``
of source text joined by ``' ;; '``, or the path of a whole other source
(``*.cu``, e.g. an earlier version kept under ``build/``).
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path


def variant_library(build, library, source_name: str, label: str, spec: str):
    """A ``build.CudaLibrary`` with ``library``'s functions for a copy of
    ``csrc/<source_name>`` edited by ``spec``, written with a copy of the
    headers beside it under ``build/<stem>_variants/``."""
    src = build.CSRC_DIR / source_name
    stem = src.stem
    text = src.read_text()
    if spec.endswith(".cu"):
        text = Path(spec).read_text()
        tag = "file_" + hashlib.sha256(text.encode()).hexdigest()[:8]
    elif "=>" in spec:
        for sub in spec.split(" ;; "):
            old, new = sub.split("=>", 1)
            if old not in text:
                raise SystemExit(f"no {old!r} in {src}")
            text = text.replace(old, new)
        tag = "sub_" + hashlib.sha256(spec.encode()).hexdigest()[:8]
    else:
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise SystemExit(f"no constant {name} in {src}")
        tag = re.sub(r"[^A-Za-z0-9]+", "_", spec)
    out_dir = build.BUILD_DIR.parent / f"{stem}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    path = out_dir / f"{stem}_{tag}.cu"
    path.write_text(text)
    lib = build.CudaLibrary(source_name, f"{stem}_{tag}", label, library.functions)
    lib.source = path
    return lib
