"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, which ``ctypes`` loads; no source includes PyTorch's
headers, so a build takes seconds.  Libraries go to ``ops/build/`` (listed
in ``.gitignore``) under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
All sources build in parallel, one ``nvcc`` each, on first use.

Nothing here runs at import time: the package imports on machines with no
``nvcc`` and no card, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit on the machine with the card")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}.{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once.
    Returns {source stem: library path}; raises with nvcc's output when a
    build fails.  ``<library>.log`` keeps ptxas' register and shared-memory
    report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {src.stem: _library_path(src) for src in sources()}
    pending = []
    for src in sources():
        lib = out[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in pending:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(stem: str, declare) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``, loaded once;
    ``declare(lib)`` sets its functions' argtypes and restype."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        declare(lib)
        _loaded[stem] = lib
    return lib
