"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``_build/`` next
to this file, named by a hash of the sources, the flags and the
compiler, so a changed source rebuilds and an unchanged one is reused.
Nothing is built at import: the first kernel call (or :func:`build`)
does it, and :func:`build` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_combine", "fused_pack")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _key(name: str, compiler: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(compiler.encode())
    return h.hexdigest()[:16]


def lib_path(name: str, compiler: str) -> Path:
    return BUILD_DIR / f"{name}-{_key(name, compiler)}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Build every library in ``names`` that is not cached, one ``nvcc``
    per source, all started together.  Returns ``{name: {"path", "hit",
    "ptxas"}}``; raises with the compiler's output if any build fails."""
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        path = lib_path(name, compiler)
        log = path.with_suffix(".log")
        if path.exists():
            out[name] = {"path": path, "hit": True,
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, log)
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, path)
        out[name] = {"path": path, "hit": False, "ptxas": text}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]["path"]))
        _LIBS[name] = lib
    return lib
