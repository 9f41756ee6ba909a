"""Artifacts that pin one registration program for serving.

Counterpart of ``pyfocusr_tpu/utils/aot.py``, with its public names and
its ``validate_artifact`` contract: ``export_registration`` /
``load_registration`` (the portable format), ``export_registration_exec`` /
``load_registration_exec`` (the compiled format) and ``validate_artifact``.

The JAX module serializes the traced program: StableHLO, or the pickled
XLA executable.  PyTorch has nothing that carries this pipeline: its
kernels are launched through ``ctypes`` (``ops/_cuda_build.py``), which
``torch.export`` cannot see; the EM and ICP loops read a stop flag on the
host (``utils/device_loop.py``); and a CUDA graph can neither be written to
disk nor moved to another process.  So an artifact pins what can be
pinned:

* **The sidecar** ``<path>.meta.json`` (written atomically, as JAX's): the
  config fingerprint (the whole ``PipelineConfig`` but ``landmark_weight``,
  which a program without landmarks never reads), the shape signature of
  each input, the format, and a hash of the package's own sources (every
  ``.py``, ``.cu``, ``.cuh`` and ``.cpp`` under ``pyfocusr_tpu_torch/``).
  The source hash stands in for "the program": an artifact serves only the
  code it was exported from, and a changed tree is refused ("re-export").
* **The portable format** (any extension but :data:`EXEC_EXT`): the file
  holds the pinned manifest (the config, the shapes, the source hash).
  Loading it builds whatever library is missing, as a fresh process does
  (``nvcc`` for the CUDA kernels, ``g++`` for the host library): the
  counterpart of JAX's StableHLO format, which re-compiles on every load.
* **The compiled format** (``.ptexec``): the file also carries the built
  shared libraries that a pair on the export device loads: the seven CUDA
  libraries on a card, and the ``g++`` host library of ``native.py``.  It is
  a ``zipfile`` behind a magic header that is checked before anything is
  opened; each library's sha256 is recorded and checked, and the libraries
  are installed under their recorded (hashed) names into the build
  directory, a temporary file renamed into place and an existing file kept,
  so processes that install at once are safe.  A fresh process then serves
  with no ``nvcc`` and no ``g++`` run.  The sidecar also pins
  ``torch.__version__``, ``torch.version.cuda`` and the device (its name
  and compute capability, or ``"cpu"``); a mismatch raises.

Every check that refuses an artifact (config, shapes, sources, device,
versions, a library's name and hash) runs before any file is installed, so a
refused artifact leaves the build directory as it was, and no library of
other sources is ever installed beside this tree's builds.

The runner, ``runner(target, source, generator=None, draws=None)``, runs
the pinned config through ``pipeline.register_pair`` on the device the
graphs lie on, after checking each input's shapes against the pinned ones;
on the same device and the same draws its results are ``register_pair``'s,
bit for bit.

What export refuses: 'hungarian' correspondences on padded graphs (JAX's
``_check_padding_hazards``).  JAX also refuses pairs above its
split-spectra threshold, because its serialized program would be the
slower fused one; the port has one path at every size, so it exports any
size.  Artifacts of the JAX package (``.jaxexp``, ``.jaxexec``) are
refused by both loaders.

.. warning:: **Trust boundary.**  A compiled artifact carries shared
   libraries, and loading one runs code from the file (``ctypes`` loads
   the libraries, as unpickling runs code in JAX's executable format).
   Only load ``.ptexec`` artifacts that you exported yourself or received
   over a channel you trust end to end.  The magic header fails a wrong or
   truncated file fast and the sha256 sums catch a corrupt copy, but
   neither is integrity protection: whoever can write the artifact can
   write both.  Across a trust boundary use the portable format: it holds
   JSON, and the libraries are built from the sources on the serving host.

Usage::

    path = export_registration(cfg, tg_example, sg_example, "reg_10k.pt")
    runner = load_registration(path)
    res = runner(tg, sg, generator)     # register_pair's output dict
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import io
import json
import os
import re
import threading
import zipfile
from pathlib import Path

import torch

from .device import resolve_device

__all__ = [
    "EXEC_EXT",
    "build_libraries",
    "export_registration",
    "export_registration_exec",
    "install_libraries",
    "load_registration",
    "load_registration_exec",
    "source_hash",
    "validate_artifact",
]

# The compiled format's extension (the CLI picks the format by it).
EXEC_EXT = ".ptexec"
# Leading bytes of each format, checked before anything else is read.
_MANIFEST_MAGIC = b"#pyfocusr_tpu_torch.manifest.v1\n"
_EXEC_MAGIC = b"#pyfocusr_tpu_torch.ptexec.v1\n"
_JAX_EXTS = (".jaxexp", ".jaxexec")
_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")
# The file name ``native.py`` gives the host library (``_cuda_build.
# library_path``): a plain name in the build directory, never a path.
_HOST_LIBRARY_NAME = re.compile(r"libpyfocusr_host_[0-9a-f]{16}\.so")


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def _shape_sig(g) -> dict:
    return {
        "points": list(g.points.shape),
        "neighbors": list(g.neighbors.shape),
        "overflow": list(g.overflow.shape),
        "node_features": list(g.node_features.shape),
    }


def source_hash() -> str:
    """sha256 over the package's sources: every ``.py``, ``.cu``, ``.cuh``
    and ``.cpp`` under ``pyfocusr_tpu_torch/``, each with its relative
    path."""
    h = hashlib.sha256()
    for p in sorted(_PACKAGE_DIR.rglob("*")):
        if p.suffix in _SOURCE_SUFFIXES and p.is_file():
            data = p.read_bytes()
            h.update(f"{p.relative_to(_PACKAGE_DIR).as_posix()}\0{len(data)}\0".encode())
            h.update(data)
    return h.hexdigest()


def _program_fingerprint(cfg) -> str:
    """The whole config but ``landmark_weight`` (JAX's rule, :108-121): the
    served program takes no landmarks."""
    from ..pipeline import PipelineConfig

    default_w = PipelineConfig.__dataclass_fields__["landmark_weight"].default
    return repr(dataclasses.replace(cfg, landmark_weight=default_w))


def _device_pin(device):
    """``"cpu"``, or the card's name and compute capability."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return {"name": torch.cuda.get_device_name(device),
            "capability": list(torch.cuda.get_device_capability(device))}


def _serving_device(target=None, device=None) -> torch.device:
    """The device a loaded artifact serves on: the target graph's, else
    ``device``, else the card (see ``utils.device.resolve_device``)."""
    return target.device if target is not None else resolve_device(device)


def _check_shapes(path: str, meta: dict, target=None, source=None) -> None:
    for name, g in (("target", target), ("source", source)):
        if g is not None and meta.get(name) != _shape_sig(g):
            raise ValueError(
                f"AOT artifact {path} was exported for {name} shapes "
                f"{meta.get(name)} but got {_shape_sig(g)}; re-export "
                "for this shape class"
            )


def _check(path: str, meta: dict, sources: str, cfg=None, target=None, source=None,
           device=None) -> None:
    """Raise ``ValueError`` where ``meta`` (a sidecar or an artifact's own
    manifest) does not fit these inputs, this tree (whose
    :func:`source_hash` is ``sources``) or this host."""
    if cfg is not None and meta.get("cfg_fingerprint") != _program_fingerprint(cfg):
        raise ValueError(
            f"AOT artifact {path} was exported under a different "
            "PipelineConfig; re-export (delete the artifact or pass a "
            "matching config)"
        )
    _check_shapes(path, meta, target, source)
    if meta.get("source_hash") != sources:
        raise ValueError(
            f"AOT artifact {path} was exported from other pyfocusr_tpu_torch "
            "sources than this tree's; re-export with this tree"
        )
    if meta.get("format") != "compiled":
        return
    here = _device_pin(_serving_device(target, device))
    if meta.get("device") != here:
        raise ValueError(
            f"AOT artifact {path} was compiled for device {meta.get('device')!r} "
            f"but serves on {here!r}; re-export (compiled artifacts are "
            "device-pinned: use the portable format to move between devices)"
        )
    for key, have in (("torch_version", torch.__version__),
                      ("cuda_version", torch.version.cuda)):
        if meta.get(key) != have:
            raise ValueError(
                f"AOT artifact {path} was compiled under {key} "
                f"{meta.get(key)!r} but this is {have!r}; re-export"
            )


def validate_artifact(path: str, cfg=None, target=None, source=None,
                      device=None) -> None:
    """Validate an artifact's sidecar against the given config and graph
    shapes, this tree's sources, and (compiled format) this host's device,
    torch and CUDA versions, WITHOUT touching the artifact bytes.  Raises
    ``ValueError`` on a mismatch; sidecar-less artifacts skip validation.
    The device is the target graph's, else ``device``, else the card.
    Shared by both loaders and by callers that hold a loaded runner and
    only need to re-check a new input (the CLI's per-source loop)."""
    _validate(path, source_hash(), cfg=cfg, target=target, source=source, device=device)


def _validate(path: str, sources: str, **inputs) -> None:
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return
    with open(mp) as f:
        meta = json.load(f)
    _check(path, meta, sources, **inputs)


def _kernel_modules():
    from ..ops import (
        cheb_step_kernel,
        cpd_estep_kernel,
        jv_kernel,
        knn_kernel,
        knn_topk_kernel,
        sinkhorn_kernel,
        umeyama_kernel,
    )

    return (knn_kernel, knn_topk_kernel, sinkhorn_kernel, jv_kernel, cpd_estep_kernel,
            umeyama_kernel, cheb_step_kernel)


def build_libraries(device) -> dict:
    """Build (where missing) and load every library a pair on ``device``
    loads: on a card the seven CUDA libraries, one ``nvcc`` each started
    together, and the host library everywhere.  Returns the seconds each
    spent in its compiler (0.0: found built)."""
    seconds = {}
    if torch.device(device).type == "cuda":
        mods = _kernel_modules()
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
            for fut in [pool.submit(mod.load_library) for mod in mods]:
                fut.result()
        seconds.update({mod.__name__.rsplit(".", 1)[1]: mod.BUILD_SECONDS for mod in mods})
    from .. import native

    native.get_lib()
    seconds["host"] = native.build_seconds()
    return seconds


def _library_files(device):
    """(file, kind) of each library :func:`build_libraries` loads."""
    from .. import native

    files = []
    if torch.device(device).type == "cuda":
        files = [(mod._LIBRARY.path(), "cuda") for mod in _kernel_modules()]
    return files + [(native.library_file(), "host")]


def _write_atomic(path: str, data: bytes) -> None:
    """Publish ``data`` at ``path`` by a rename: a process killed mid-write
    leaves no truncated file there."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _manifest(cfg, target_example, source_example, fmt: str) -> dict:
    from ..pipeline import _check_padding_hazards, _n_real_vertices

    # An exported 'hungarian' program must not serve assignments over
    # padding rows: the guard register_pair runs, applied at export.
    _check_padding_hazards(target_example, source_example, cfg,
                           _n_real_vertices(target_example, source_example))
    return {
        "format": fmt,
        "config": dataclasses.asdict(cfg),
        "cfg_fingerprint": _program_fingerprint(cfg),
        "target": _shape_sig(target_example),
        "source": _shape_sig(source_example),
        "source_hash": source_hash(),
    }


def _publish(path: str, body: bytes, manifest: dict) -> str:
    _write_atomic(path, body)
    # The sidecar: the manifest without the config itself, so a loader can
    # refuse an artifact without opening it.
    meta = {k: v for k, v in manifest.items() if k != "config"}
    _write_atomic(_meta_path(path), json.dumps(meta).encode())
    return path


def _refuse_jax(path: str) -> None:
    if path.endswith(_JAX_EXTS):
        raise ValueError(
            f"{path} is an artifact of the JAX package (pyfocusr_tpu); "
            "pyfocusr_tpu_torch serves only its own artifacts: re-export with "
            "pyfocusr_tpu_torch.utils.aot"
        )


def _runner(manifest: dict, path: str):
    from ..pipeline import config_from_dict, register_pair

    cfg = config_from_dict(manifest["config"])

    def runner(target, source, generator=None, draws=None):
        _check_shapes(path, manifest, target, source)
        return register_pair(target, source, cfg, generator=generator, draws=draws)

    return runner


def export_registration(cfg, target_example, source_example, path: str) -> str:
    """Write the portable artifact of ``register_pair`` under ``cfg`` for
    inputs shaped as the examples (vertex counts, ELL degree, overflow
    length, feature count) to ``path``, and its sidecar.  Builds nothing:
    the loader builds what its host lacks."""
    manifest = _manifest(cfg, target_example, source_example, "portable")
    return _publish(path, _MANIFEST_MAGIC + json.dumps(manifest).encode(), manifest)


def load_registration(path: str, cfg=None, target=None, source=None, device=None):
    """Load a portable artifact; returns ``runner(target, source,
    generator=None, draws=None)``.  With ``cfg`` / ``target`` / ``source``
    the sidecar is validated against them (:func:`validate_artifact`); the
    artifact's own sources are checked against this tree's always.  Builds
    the libraries the serving device (the target's, else ``device``, else
    the card) loads, where they are missing."""
    _refuse_jax(path)
    sources = source_hash()
    _validate(path, sources, cfg=cfg, target=target, source=source, device=device)
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(_EXEC_MAGIC):
        raise ValueError(f"{path} is a compiled artifact: load it with "
                         "load_registration_exec")
    if not raw.startswith(_MANIFEST_MAGIC):
        raise ValueError(
            f"{path} is not a pyfocusr_tpu_torch portable artifact (missing "
            f"{_MANIFEST_MAGIC!r} header): a wrong or truncated file; "
            "re-export with export_registration"
        )
    manifest = json.loads(raw[len(_MANIFEST_MAGIC):])
    _check(path, manifest, sources)
    build_libraries(_serving_device(target, device))
    return _runner(manifest, path)


def export_registration_exec(cfg, target_example, source_example, path: str) -> str:
    """Write the compiled artifact to ``path`` (conventionally
    :data:`EXEC_EXT`) and its sidecar: the manifest, and every library a
    pair on the examples' device loads, built here where missing.  Pinned
    to this device, torch and CUDA version (see the module docstring)."""
    device = target_example.device
    manifest = _manifest(cfg, target_example, source_example, "compiled")
    build_libraries(device)
    libs = []
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for file, kind in _library_files(device):
            data = Path(file).read_bytes()
            libs.append({"name": Path(file).name, "kind": kind,
                         "sha256": hashlib.sha256(data).hexdigest()})
            zf.writestr(f"lib/{Path(file).name}", data)
        manifest.update(device=_device_pin(device), torch_version=torch.__version__,
                        cuda_version=torch.version.cuda, libraries=libs)
        zf.writestr("manifest.json", json.dumps(manifest))
    return _publish(path, _EXEC_MAGIC + buf.getvalue(), manifest)


def install_libraries(path: str, device=None) -> dict:
    """Check a compiled artifact and install its libraries; returns its
    manifest.  The header is checked before anything is opened; then the
    sources, the device (``device``, else the card), the torch and CUDA
    versions, each library's name (a CUDA library's must be the one this
    tree would build, the host library's a plain file name of
    ``native.py``'s form) and each library's sha256, all before any file is
    written.  Each library goes into the build directory under its recorded
    name (a file already there is kept: the same name is the same build),
    and the host library is served from there without ``g++``.  Safe to
    call again."""
    return _install(path, device, source_hash())


def _install(path: str, device, sources: str) -> dict:
    from .. import native
    from ..ops import _cuda_build

    _refuse_jax(path)
    with open(path, "rb") as f:
        head = f.read(len(_EXEC_MAGIC))
        if head != _EXEC_MAGIC:
            raise ValueError(
                f"{path} is not a pyfocusr_tpu_torch compiled artifact (missing "
                f"{_EXEC_MAGIC!r} header): a wrong file, a truncated copy or a "
                "portable artifact (use load_registration); re-export with "
                "export_registration_exec"
            )
        body = f.read()
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        _check(path, manifest, sources, device=device)
        ours = {mod._LIBRARY.path().name for mod in _kernel_modules()}
        blobs = []
        for lib in manifest["libraries"]:
            if lib["kind"] == "cuda" and lib["name"] not in ours:
                raise ValueError(f"{path}: library {lib['name']} is not one this "
                                 "tree builds; re-export")
            if lib["kind"] != "cuda" and not (lib["kind"] == "host"
                                              and _HOST_LIBRARY_NAME.fullmatch(lib["name"])):
                raise ValueError(f"{path}: {lib['kind']!r} library {lib['name']!r} is not "
                                 "a library file this tree builds; re-export")
            data = zf.read(f"lib/{lib['name']}")
            if hashlib.sha256(data).hexdigest() != lib["sha256"]:
                raise ValueError(f"{path}: library {lib['name']} does not match its "
                                 "recorded sha256 (a corrupt copy); re-export")
            blobs.append((lib, data))
    for lib, data in blobs:
        dest = _cuda_build.BUILD_DIR / lib["name"]
        if not dest.exists():
            dest.parent.mkdir(parents=True, exist_ok=True)
            _write_atomic(str(dest), data)
        if lib["kind"] == "host":
            native.use_prebuilt(dest)
    return manifest


def load_registration_exec(path: str, cfg=None, target=None, source=None, device=None,
                           installed=None):
    """Load a compiled artifact: validate its sidecar (as
    :func:`validate_artifact`), install its libraries
    (:func:`install_libraries`) and load them; returns the same
    ``runner(target, source, generator=None, draws=None)`` as
    :func:`load_registration`, with nothing built.  ``installed``: the
    manifest :func:`install_libraries` returned for ``path`` in this
    process, which skips the install.

    .. warning:: the artifact carries shared libraries, and loading it runs
       code from the file; see the module's trust-boundary warning."""
    _refuse_jax(path)
    sources = source_hash()
    _validate(path, sources, cfg=cfg, target=target, source=source, device=device)
    serving = _serving_device(target, device)
    manifest = installed if installed is not None else _install(path, serving, sources)
    build_libraries(serving)
    return _runner(manifest, path)
