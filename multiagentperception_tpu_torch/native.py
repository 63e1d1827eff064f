"""ctypes binding of the port's native batch PNG decoder (``csrc/decoder.cpp``).

The port's own copy of ``multiagentperception_tpu/native/__init__.py``
(:1-137); keep the two in step. The C++ thread pool decodes all views of a
frame concurrently straight into one (N, H, W, C) uint8 block. It is the
loader's decoder where cv2 does not import (``data/airsim.py``).

The library is built at first use, with
``g++ -O2 -fPIC -shared -std=c++17 csrc/decoder.cpp -lpng``, into
``build/native/libmapdecode-<hash>.so`` under the package (a directory
``.gitignore`` lists; the hash covers the source and the flags, so an edited
source is rebuilt). The compiler's temporary files go there too. It needs
``g++`` and libpng's headers and library on the host; nothing is installed
for it. Unlike the JAX copy, a build that fails is an error that carries
the compiler's output (``NativeBuildError``), and one that does not load
raises the loader's ``OSError``: never a quiet fallback to another
decoder. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "decoder.cpp"
BUILD_DIR = _PKG / "build" / "native"
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 300

# error codes of csrc/decoder.cpp
ERRORS = {-1: "cannot open", -2: "not a PNG", -3: "decode failed",
          -4: "output buffer too small", -5: "geometry differs from the batch's"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The native decoder could not be built; the message holds why (the
    compiler's stderr where it ran)."""


def library_path() -> Path:
    """Where the build for this source and these flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmapdecode-{digest}.so"


def build() -> Path:
    """Build the library if this source has no build yet; returns its path.
    Raises ``NativeBuildError`` with the compiler's stderr if it fails.
    Concurrent builds each write a file of their own and rename it."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("the native PNG decoder needs g++, which is not on PATH")
    tmpdir = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmpdir.mkdir(parents=True, exist_ok=True)
    part = tmpdir / out.name
    cmd = [gxx, *FLAGS, str(SOURCE), "-lpng", "-o", str(part)]
    try:
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
                             env={**os.environ, "TMPDIR": str(tmpdir)})
        if run.returncode != 0:
            raise NativeBuildError(f"building the native PNG decoder failed "
                                   f"({' '.join(cmd)}; rc {run.returncode}):\n{run.stderr}")
        os.replace(part, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The library, built if need be and bound; raises ``NativeBuildError``
    if it does not build and ``OSError`` if it does not load (a libpng
    found at link time but not at run time)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.map_png_info.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
        lib.map_png_info.restype = ctypes.c_int
        lib.map_decode_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64, i32p, i32p, i32p]
        lib.map_decode_png.restype = ctypes.c_int
        lib.map_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, u8p,
                                         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32]
        lib.map_decode_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the decoder builds and loads here."""
    try:
        load()
    except (NativeBuildError, OSError):
        return False
    return True


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise IOError(f"{what}: {ERRORS.get(rc, 'error')} (code {rc})")


def png_info(path: str) -> tuple[int, int, int]:
    """(width, height, channels) of a PNG, as it decodes (8-bit RGB(A))."""
    lib = load()
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    _check(lib.map_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)),
           f"png_info({path})")
    return w.value, h.value, c.value


def decode_image(path: str) -> np.ndarray:
    """Decode one PNG to an (H, W, C) uint8 RGB(A) array."""
    lib = load()
    w, h, c = png_info(path)
    out = np.empty((h, w, c), dtype=np.uint8)
    wo, ho, co = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    _check(lib.map_decode_png(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              out.nbytes, ctypes.byref(wo), ctypes.byref(ho), ctypes.byref(co)),
           f"decode_image({path})")
    return out


def decode_batch(paths, height: int, width: int, channels: int = 3,
                 nthreads: int = 0) -> np.ndarray:
    """Decode same-geometry PNGs concurrently into one (N, H, W, C) block;
    ``nthreads`` 0 takes one thread per core, at most one per image."""
    lib = load()
    n = len(paths)
    out = np.empty((n, height, width, channels), dtype=np.uint8)
    encoded = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    _check(lib.map_decode_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                height * width * channels, width, height, channels, nthreads),
           f"decode_batch of {n} images at {height}x{width}x{channels}")
    return out
