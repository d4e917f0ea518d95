"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc, on first use, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.  :func:`build` starts one nvcc
per missing library, all at once, and waits for them.

There is no fallback: a missing nvcc or a failed build raises
:class:`KernelBuildError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("packed_clause", "class_sum", "fused_step", "ta_update",
           "clause_eval")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_typed: set = set()


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile or load."""


def find_nvcc(nvcc: Optional[str] = None) -> str:
    """The nvcc to use: ``nvcc`` if given, else the one on PATH, else the
    CUDA toolkit's default location.  Raises if none exists."""
    candidates = ([nvcc] if nvcc is not None
                  else [shutil.which("nvcc"), DEFAULT_NVCC])
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        f"nvcc not found (tried {[c for c in candidates if c]}); the CUDA "
        "kernels cannot be built")


def library_path(name: str, build_dir: Optional[pathlib.Path] = None
                 ) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources: the hash covers that source, every header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return (build_dir or BUILD_DIR) / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          build_dir: Optional[pathlib.Path] = None
          ) -> Dict[str, pathlib.Path]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together.  Returns {name: library path}.  The
    compiler's log (ptxas register and shared-memory report included) is
    kept beside each library as ``<library>.log``."""
    names = list(names)
    for n in names:
        if n not in SOURCES:
            raise KernelBuildError(f"unknown kernel source {n!r}")
    paths = {n: library_path(n, build_dir) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    exe = find_nvcc()
    out_dir = next(iter(todo.values())).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n, p in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT),
                        tmp, cmd)
        failed = []
        for n, (proc, tmp, cmd) in procs.items():
            log, _ = proc.communicate()
            todo[n].with_suffix(".so.log").write_bytes(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
                continue
            os.replace(tmp, todo[n])
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        lib.dtm_error_string.argtypes = [ctypes.c_int]
        lib.dtm_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def entry(name: str, fn: str, argtypes, restype=ctypes.c_int):
    """(library, C entry point ``fn`` of ``csrc/<name>.cu``), its ctypes
    signature set once, when it is first looked up."""
    lib = load(name)
    f = getattr(lib, fn)
    if (name, fn) not in _typed:
        f.argtypes = list(argtypes)
        f.restype = restype
        _typed.add((name, fn))
    return lib, f


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = lib.dtm_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
