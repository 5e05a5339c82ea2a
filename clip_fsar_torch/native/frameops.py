"""ctypes binding for the native frame-preprocessing library (counterpart of
clip_fsar_tpu/native/frameops.py:32-110; the C++ source beside it is a copy of
clip_fsar_tpu/native/frameops.cpp).

``libframeops.so`` is built from frameops.cpp with g++ at first use into
``build/native/<hash>/`` under the repository root (git-ignored), keyed by a
hash of the source, the flags and the host CPU's feature flags.  ``available()`` is False where there is no
g++ (or the build or the load failed; ``failure()`` then says why), and the
transforms take their numpy replica, whose pixels are identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "frameops.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]
_LIB_NAME = "libframeops.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_failure: Optional[str] = None
_enabled = True
_lock = threading.Lock()


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` compiles for them, so a library built on
    one host must not be reused on another."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith(("flags", "Features"))), "")
    except OSError:
        return ""


def _build() -> Optional[str]:
    """Compile the library unless this source/flag combination has one; returns its path, or None
    (with the reason kept for ``failure()``) where there is no g++ or the compiler failed."""
    global _failure
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256((" ".join(CXX_FLAGS) + _cpu_flags()).encode() + f.read()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    if shutil.which("g++") is None:
        _failure = "no g++ on PATH"
        return None
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        tmp = os.path.join(work, _LIB_NAME)
        try:
            subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
            _failure = f"g++ failed: {e}: {getattr(e, 'stderr', b'')[-2000:]!r}"
            return None
        os.replace(tmp, lib_path)  # atomic: a concurrent build or load sees the whole file or none
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _failure
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            logger.info("native frameops not built (%s); the transforms use the numpy replica", _failure)
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _failure = f"load failed: {e}"
            logger.info("native frameops %s; the transforms use the numpy replica", _failure)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.clip_resize_crop_flip.argtypes = [u8p] + [ctypes.c_int] * 10 + [u8p]
        lib.clip_resize_crop_flip.restype = ctypes.c_int
        lib.clip_resize.argtypes = [u8p] + [ctypes.c_int] * 5 + [u8p]
        lib.clip_resize.restype = ctypes.c_int
        lib.frameops_num_threads.restype = ctypes.c_int
        _lib = lib
        logger.info("native frameops loaded from %s (%d OpenMP threads)", path, lib.frameops_num_threads())
        return _lib


def available() -> bool:
    """True when the library is built, loaded and not switched off by ``set_enabled(False)``."""
    return _enabled and _load() is not None


def failure() -> Optional[str]:
    """Why the library is not loaded (None when it is, or before the first attempt)."""
    return _failure


def set_enabled(flag: bool) -> None:
    """Switch the native path off (the transforms then run the numpy replica) or back on; for
    measuring one against the other in one process."""
    global _enabled
    _enabled = bool(flag)


def num_threads() -> int:
    """OpenMP threads the library runs a clip's frames on: the OpenMP default, which the
    environment's OMP_NUM_THREADS sets (0 when the library is not loaded).  The loader's worker
    threads each call the library, so workers x this many threads share the host's cores."""
    lib = _load()
    return lib.frameops_num_threads() if lib is not None else 0


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_crop_flip(
    frames: np.ndarray,
    out_h: int,
    out_w: int,
    crop_y: int,
    crop_x: int,
    crop_h: int,
    crop_w: int,
    flip: bool = False,
) -> np.ndarray:
    """Fused bilinear-resize(+crop+flip) of a uint8 [T, H, W, 3] clip:
    resize the clip to (out_h, out_w), take the (crop_h, crop_w) window at
    (crop_y, crop_x), optionally mirror horizontally — one C++ pass, only
    cropped pixels computed."""
    lib = _load()
    assert lib is not None, "native frameops unavailable — guard with available()"
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    assert c == 3
    out = np.empty((t, crop_h, crop_w, 3), np.uint8)
    rc = lib.clip_resize_crop_flip(
        _u8p(frames), t, h, w, out_h, out_w, crop_y, crop_x, crop_h, crop_w, int(flip), _u8p(out)
    )
    if rc != 0:
        raise ValueError(f"invalid crop window ({crop_y},{crop_x},{crop_h},{crop_w}) for resize ({out_h},{out_w})")
    return out


def resize(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native frameops unavailable — guard with available()"
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, _ = frames.shape
    out = np.empty((t, out_h, out_w, 3), np.uint8)
    lib.clip_resize(_u8p(frames), t, h, w, out_h, out_w, _u8p(out))
    return out
