"""ctypes loader for the native host decoder (``native/devt_host.cpp``).

The port's own build and bindings of the C++ decode → resize → crop →
normalize path (the DALI role of the reference, SURVEY.md §2.7): JPEG and
PNG frames, in threads, straight into a caller's buffer, MJPEG-in-AVI
video, and the exact-kNN index with Annoy's surface (:class:`AnnIndex`)
that the retrieval tool uses.

Build: ``g++`` as ``native/Makefile`` compiles it (``-O3 -fPIC -std=c++17
-shared … -ljpeg -lpng -lpthread``), on first use, into ``data/build/``
(listed in ``.gitignore``) under a name that carries a hash of the source
and the flags.  The library is written to a temporary file of its own and
moved into place, so builds that run at once (threads or processes) and
an edited source are both safe.  Nothing here writes ``native/build/``.

``available()`` is true when the library builds and loads; when it does
not, :func:`unavailable_reason` keeps the compiler's message, and every
consumer decodes with PIL instead, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "devt_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")


class _State:
    """The process's one load attempt: the library, or why there is none."""

    lib: ctypes.CDLL | None = None
    reason: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes() if SOURCE.exists() else b"")
    return BUILD_DIR / f"libdevt_host.{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    lib = library_path()
    if lib.exists():
        return lib
    if not SOURCE.exists():
        raise RuntimeError(f"no native source at {SOURCE}")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{lib.stem}.",
                                suffix=".tmp")
    os.close(fd)
    tmp = Path(name)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                               *LIBS], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}".strip())
    os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    c_int, c_char_p = ctypes.c_int, ctypes.c_char_p
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    paths = ctypes.POINTER(c_char_p)
    for name, args in (
            ("devt_load_image_f32", [c_char_p, c_int, c_int, f32p, f32p,
                                     f32p]),
            ("devt_load_batch_f32", [paths, c_int, c_int, c_int, f32p, f32p,
                                     f32p, i32p, c_int]),
            ("devt_load_batch_u8", [paths, c_int, c_int, c_int, u8p, i32p,
                                    c_int]),
            ("devt_load_batch_u8_patches", [paths, c_int, c_int, c_int,
                                            c_int, u8p, i32p, c_int]),
            ("devt_image_dims", [c_char_p, i32p, i32p]),
            ("devt_video_info", [c_char_p, i32p, i32p, i32p]),
            ("devt_video_decode_rgb8", [c_char_p, u8p, c_int, c_int, c_int,
                                        c_int]),
            ("devt_video_decode_f32", [c_char_p, c_int, c_int, f32p, f32p,
                                       f32p, c_int, c_int])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = c_int
    # the index (devt_tpu/native.py:84-95)
    handle = ctypes.c_void_p
    for name, args, res in (
            ("devt_ann_create", [c_int], handle),
            ("devt_ann_destroy", [handle], None),
            ("devt_ann_add", [handle, f32p], None),
            ("devt_ann_size", [handle], c_int),
            ("devt_ann_query", [handle, f32p, c_int, i32p, f32p], None),
            ("devt_ann_save", [handle, c_char_p], c_int),
            ("devt_ann_load", [c_char_p], handle)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def _load() -> ctypes.CDLL | None:
    if _State.lib is None and _State.reason is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _State.reason = str(e)
        else:
            _declare(lib)
            _State.lib = lib
    return _State.lib


def available() -> bool:
    """True when the library builds (or is built) and loads here."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why :func:`available` is false: the compiler's or loader's
    message; None when the library loaded."""
    _load()
    return _State.reason


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_State.reason}")
    return lib


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _stats(mean, std) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(std, np.float32))


def _threads(nthreads: int | None) -> int:
    # more threads than cores measurably hurts on small hosts
    return nthreads if nthreads is not None else min(8, os.cpu_count() or 1)


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _out_buffer(out: np.ndarray | None, shape: tuple, dtype) -> np.ndarray:
    """The decode target: a new zeroed array, or the caller's (a batch
    slot: the Loader's fill-into contract, ``data/pipeline.py``), which
    must be C-contiguous and of the exact shape and dtype; it is zeroed,
    since a failed decode leaves its image as it finds it."""
    if out is None:
        return np.zeros(shape, dtype)
    if out.shape != shape or out.dtype != np.dtype(dtype):
        raise ValueError(f"out is {out.shape} {out.dtype}, the decode "
                         f"writes {shape} {np.dtype(dtype)}")
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    out[...] = 0
    return out


def load_image_f32(path: str, resize: int, crop: int,
                   mean: Sequence[float], std: Sequence[float]
                   ) -> np.ndarray | None:
    """Fused decode → resize(shorter) → center-crop → normalize →
    (crop, crop, 3) f32, or None when the decode fails."""
    lib = _lib()
    out = np.empty((crop, crop, 3), np.float32)
    mean, std = _stats(mean, std)
    rc = lib.devt_load_image_f32(path.encode(), resize, crop, _f32p(mean),
                                 _f32p(std), _f32p(out))
    return out if rc == 0 else None


def load_batch_f32(paths: Sequence[str], resize: int, crop: int,
                   mean: Sequence[float], std: Sequence[float],
                   nthreads: int | None = None, out: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch load → ((N, crop, crop, 3) f32, (N,) status int32).
    A failed decode leaves a zero image and a nonzero status."""
    lib = _lib()
    n = len(paths)
    out = _out_buffer(out, (n, crop, crop, 3), np.float32)
    status = np.zeros((n,), np.int32)
    mean, std = _stats(mean, std)
    lib.devt_load_batch_f32(_c_paths(paths), n, resize, crop, _f32p(mean),
                            _f32p(std), _f32p(out), _i32p(status),
                            _threads(nthreads))
    return out, status


def load_batch_u8(paths: Sequence[str], resize: int, crop: int,
                  nthreads: int | None = None, out: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch load, u8 wire → ((N, crop, crop, 3) u8, (N,) status
    int32): the pixels :func:`load_batch_f32` normalizes (its resize
    rounds to uint8 too), left for ``data/device_norm.py`` to normalize
    on the card."""
    lib = _lib()
    n = len(paths)
    out = _out_buffer(out, (n, crop, crop, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    lib.devt_load_batch_u8(_c_paths(paths), n, resize, crop, _u8p(out),
                           _i32p(status), _threads(nthreads))
    return out, status


def load_batch_u8_patches(paths: Sequence[str], resize: int, crop: int,
                          patch: int, nthreads: int | None = None,
                          out: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch load, pre-patchified u8 wire →
    ((N, (crop/patch)**2, patch*patch*3) u8 tokens, (N,) status int32):
    :func:`load_batch_u8`'s pixels in the ViT token order (p1, p2, c)."""
    if crop % patch:
        raise ValueError(f"crop {crop} is no multiple of patch {patch}")
    lib = _lib()
    n, g = len(paths), crop // patch
    out = _out_buffer(out, (n, g * g, patch * patch * 3), np.uint8)
    status = np.zeros((n,), np.int32)
    rc = lib.devt_load_batch_u8_patches(_c_paths(paths), n, resize, crop,
                                        patch, _u8p(out), _i32p(status),
                                        _threads(nthreads))
    if rc != 0:
        raise RuntimeError(f"devt_load_batch_u8_patches returned {rc}")
    return out, status


def image_dims(path: str) -> tuple[int, int] | None:
    """(width, height) of an image file, or None when it does not decode."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _lib().devt_image_dims(path.encode(), ctypes.byref(w),
                                ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def video_info(path: str) -> tuple[int, int, int] | None:
    """(n_frames, width, height) of an MJPEG/.avi video, or None."""
    n, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().devt_video_info(path.encode(), ctypes.byref(n),
                                ctypes.byref(w), ctypes.byref(h))
    return (n.value, w.value, h.value) if rc == 0 else None


def load_video_rgb8(path: str, max_frames: int = 1 << 16,
                    nthreads: int | None = None) -> np.ndarray | None:
    """Decode an MJPEG/.avi video → (N, H, W, 3) uint8 (the ffmpeg role
    of the reference's shot pipeline, spatio_cut.py:11-33)."""
    lib = _lib()
    info = video_info(path)
    if info is None:
        return None
    n, w, h = info
    n = min(n, max_frames)
    out = np.zeros((n, h, w, 3), np.uint8)
    got = lib.devt_video_decode_rgb8(path.encode(), _u8p(out), n, w, h,
                                     _threads(nthreads))
    return out[:got] if got > 0 else None


def load_video_f32(path: str, resize: int, crop: int,
                   mean: Sequence[float], std: Sequence[float],
                   max_frames: int = 1 << 16,
                   nthreads: int | None = None) -> np.ndarray | None:
    """Fused video decode → resize → crop → normalize →
    (N, crop, crop, 3) f32."""
    lib = _lib()
    info = video_info(path)
    if info is None:
        return None
    n = min(info[0], max_frames)
    out = np.zeros((n, crop, crop, 3), np.float32)
    mean, std = _stats(mean, std)
    got = lib.devt_video_decode_f32(path.encode(), resize, crop, _f32p(mean),
                                    _f32p(std), _f32p(out), n,
                                    _threads(nthreads))
    return out[:got] if got > 0 else None


class AnnIndex:
    """Exact-kNN index with the Annoy surface the retrieval tool uses
    (``add_item`` / ``build`` / ``get_nns_by_vector`` / ``save`` /
    ``load``): ``devt_tpu/native.py:AnnIndex`` on the port's build of the
    same source.  Euclidean distances; item ids are the order of
    ``add_item`` calls."""

    def __init__(self, dim: int, _handle=None):
        self._lib = _lib()
        self.dim = dim
        self._h = _handle or self._lib.devt_ann_create(dim)

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.devt_ann_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.devt_ann_size(self._h)

    def add_item(self, _i: int, vector: Sequence[float]) -> None:
        v = np.ascontiguousarray(vector, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"vector of shape {v.shape}, the index holds "
                             f"({self.dim},)")
        self._lib.devt_ann_add(self._h, _f32p(v))

    def build(self, _n_trees: int = 0) -> None:
        """Nothing to build: the index is exact (Annoy's trees' count is
        taken and ignored)."""

    def get_nns_by_vector(self, vector: Sequence[float], k: int,
                          include_distances: bool = False):
        v = np.ascontiguousarray(vector, np.float32)
        k = min(k, len(self))
        ids = np.zeros((k,), np.int32)
        dists = np.zeros((k,), np.float32)
        self._lib.devt_ann_query(self._h, _f32p(v), k, _i32p(ids),
                                 _f32p(dists))
        if include_distances:
            return ids.tolist(), dists.tolist()
        return ids.tolist()

    def save(self, path: str) -> None:
        if self._lib.devt_ann_save(self._h, path.encode()) != 0:
            raise OSError(f"failed to save the index to {path}")

    @classmethod
    def load(cls, dim: int, path: str) -> "AnnIndex":
        handle = _lib().devt_ann_load(path.encode())
        if not handle:
            raise OSError(f"failed to load the index {path}")
        return cls(dim, _handle=handle)
