"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``sagan_tpu_torch/csrc/<name>.cu`` exposes a plain C interface (the
``.cuh`` headers beside them hold shared device code) and is compiled,
at first use, into ``build/kernels/lib<name>[_<define>]-<hash>.so`` at
the root of the checkout, once for each set of ``-D`` defines asked for;
the hash covers the source, the headers and the flags, so an edit never
loads a stale library.  Nothing here runs when the module is imported: a machine
without ``nvcc`` (the CPU tests) imports it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to with ``defines`` (``-DX=1``
    flags), named by a hash of its source, the shared headers
    (``csrc/*.cuh``) and all the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    tag = "".join(f"_{d.split('=')[-1]}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest.hexdigest()[:16]}.so"


def build(specs) -> dict:
    """Compile every ``(name, defines)`` in ``specs`` that is not built
    yet, one ``nvcc`` per library, all started together.  The compiler's
    report (registers, spills) goes beside each library as ``.log``.
    Returns {spec: library path}; raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {(name, tuple(defs)): library_path(name, tuple(defs))
             for name, defs in specs}
    procs = {}
    for (name, defs), path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *defs, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name, defs] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for spec, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[spec].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc {spec} exited {proc.returncode}:\n{out}")
            continue
        os.replace(tmp, paths[spec])  # atomic: readers see all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built on first call."""
    spec = (name, tuple(defines))
    with _lock:
        if spec not in _libs:
            _libs[spec] = ctypes.CDLL(str(build([spec])[spec]))
        return _libs[spec]
