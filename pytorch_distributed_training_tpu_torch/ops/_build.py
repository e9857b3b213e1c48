"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each source under ``csrc/`` compiles on its own into
``<repo>/build/torch_kernels/<name>-<hash>.so``, where the hash covers the
source text and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  ``build()`` starts one nvcc per missing
library, all at once, and waits for them.  Nothing here runs at import
time; a missing nvcc raises when a kernel is first needed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("decode_attention.cu", "paged_attention.cu", "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then the one on
    PATH, then ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of this package are built from source at first use"
    )


def library_path(source: str) -> pathlib.Path:
    """Where ``source`` builds to: keyed by a hash of its text and flags."""
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{digest[:16]}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{source: ptxas report}`` for the sources built now (the
    register and shared-memory use nvcc prints with ``-Xptxas -v``).
    Raises with nvcc's output when a build fails.
    """
    todo = {s: library_path(s) for s in sources if not library_path(s).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for src, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, lib)
        reports[src] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    build((source,))
    return ctypes.CDLL(str(library_path(source)))
