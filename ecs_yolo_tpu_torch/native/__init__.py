"""ctypes bindings for the native (C++) kernels of the host input pipeline
(counterpart of ``ecs_yolo_tpu/native/__init__.py``): ``warp_perspective``,
``hsv_jitter`` and ``paint_events``.

``native/augment.cpp`` is built at first use with the host compiler (``CXX``,
else ``g++``) into the port's ignored ``_build/libaugment-<hash>.so``, with
the JAX package's flags but ``-fopenmp``: the loader's threads already run
one sample each, and a compiler need not ship OpenMP's runtime (each pixel
is computed alone, so the output is the same bit for bit).  The hash is
taken over the source, the flags, the compiler's name and the host CPU's
feature flags (``-march=native`` code built on one CPU may not run on
another).  The build holds a file lock and writes a temporary file that is
renamed into place, so processes building at once never load a
half-written library.  A failed build raises: nothing falls back to another
route (the JAX package quietly drops to PIL; here the caller asks for the
PIL route with ``native=False`` where it wants it).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            return next((ln for ln in fh if ln.startswith("flags")), "")
    except OSError:
        return ""


def target() -> Path:
    key = " ".join([*CXX_FLAGS, os.environ.get("CXX", "g++"), platform.machine(),
                    _cpu_flags()])
    digest = hashlib.sha256(SOURCE.read_bytes() + key.encode())
    return BUILD_DIR / f"libaugment-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled first unless it is there.  Raises when
    the compiler fails."""
    out = target()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # one process compiles at a time
        if out.is_file():                       # another process built it
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed ({cxx} exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.warp_perspective_u8.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_uint8, ctypes.c_uint8,
                ctypes.c_uint8,
            ]
            lib.hsv_jitter_u8.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ]
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.paint_events_u8.argtypes = [
                i32p, i32p, i32p, ctypes.c_int64, u8p, ctypes.c_int, ctypes.c_int,
            ]
            for fn in (lib.warp_perspective_u8, lib.hsv_jitter_u8, lib.paint_events_u8):
                fn.restype = None
            _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads here.  Nothing falls back on
    ``False``: a caller that wants the PIL route asks for it itself."""
    try:
        get_lib()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _rgb(img: np.ndarray) -> np.ndarray:
    """``img`` as a contiguous uint8 [H, W, 3] array, or a ValueError."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 [H, W, 3] image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    return np.ascontiguousarray(img)


def warp_perspective(src: np.ndarray, minv: np.ndarray, out_hw, fill=(114, 114, 114)):
    """Inverse-mapped bilinear warp; ``minv`` maps OUTPUT -> INPUT (3x3)."""
    lib = get_lib()
    src = _rgb(src)
    m = np.ascontiguousarray(minv, np.float64)
    if m.shape != (3, 3):
        raise ValueError(f"minv must be 3x3, got {m.shape}")
    dh, dw = out_hw
    dst = np.empty((dh, dw, 3), np.uint8)
    lib.warp_perspective_u8(
        _u8(src), src.shape[0], src.shape[1],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8(dst), dh, dw, fill[0], fill[1], fill[2],
    )
    return dst


def hsv_jitter(img: np.ndarray, rh: float, rs: float, rv: float):
    """HSV gains applied in place (OpenCV conventions); returns ``img``."""
    lib = get_lib()
    img = _rgb(img)
    lib.hsv_jitter_u8(_u8(img), img.shape[0], img.shape[1], rh, rs, rv)
    return img


def paint_events(xs, ys, ps, canvas: np.ndarray) -> np.ndarray:
    """Events painted in place on the uint8 ``[H, W, 3]`` ``canvas``: 255
    where the polarity ``ps`` is positive, else 0, at (``xs``, ``ys``)
    clamped to the canvas; a later event overwrites an earlier one.  Returns
    ``canvas`` (``data/events.paint_events`` is the numpy painter)."""
    lib = get_lib()
    if not (canvas.flags.c_contiguous and canvas.flags.writeable):
        raise ValueError("canvas must be a writeable contiguous array")
    canvas = _rgb(canvas)
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    ps = np.ascontiguousarray(ps, np.int32)
    if not len(xs) == len(ys) == len(ps):
        raise ValueError(f"xs, ys, ps differ in length: {len(xs)}, {len(ys)}, {len(ps)}")
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.paint_events_u8(
        xs.ctypes.data_as(i32), ys.ctypes.data_as(i32), ps.ctypes.data_as(i32),
        len(xs), _u8(canvas), canvas.shape[0], canvas.shape[1],
    )
    return canvas
