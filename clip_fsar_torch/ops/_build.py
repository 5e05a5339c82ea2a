"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library goes to
``build/kernels/<hash>/`` under the repository root (git-ignored), keyed by a
hash of the sources, the headers they include and the flags, so a second
process reuses it and an edited source rebuilds.  Nothing is built at
import: the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_LIB_NAME = "libclip_fsar_kernels.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _compile_all(nvcc: str, srcs: list, work: str) -> list:
    """One nvcc per source, all running at once; returns the object paths.
    Raises with the compiler's errors if any of them fails."""
    objs = [os.path.join(work, os.path.basename(src) + ".o") for src in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    logs = [(src, proc.communicate()[0], proc.returncode) for src, proc in zip(srcs, procs)]
    with open(os.path.join(work, "nvcc.log"), "w") as f:
        for src, out, _ in logs:
            f.write(f"== {os.path.basename(src)}\n{out}")
    failed = [(src, out, rc) for src, out, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{os.path.basename(s)} ({rc}):\n{out[-4000:]}" for s, out, rc in failed))
    return objs


def build() -> str:
    """Compile the kernels if this source/header/flag combination has no
    library yet; returns the library path.  The compilers' ``-Xptxas -v``
    report (registers, shared memory, spills per kernel) is kept as
    ``nvcc.log`` beside it."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = _compile_all(nvcc, srcs, work)
        tmp = os.path.join(work, _LIB_NAME)
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(os.path.join(work, "nvcc.log"), os.path.join(out_dir, "nvcc.log"))
        os.replace(tmp, lib_path)  # atomic: a concurrent builder sees the whole file or none
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(build())
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.clip_mha_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.clip_mha_fwd.restype = i
    lib.clip_mha_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.clip_mha_bwd.restype = i
    # pointers, then (B, H, Nq, Nk, Dh, dtype, causal), then (batch, head, sequence) strides per operand
    lib.flash_mha_fwd.argtypes = [p] * 5 + [i] * 7 + [l] * 9 + [p]
    lib.flash_mha_fwd.restype = i
    lib.flash_mha_bwd_dq.argtypes = [p] * 8 + [i] * 7 + [l] * 12 + [p]
    lib.flash_mha_bwd_dq.restype = i
    lib.flash_mha_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [l] * 12 + [p]
    lib.flash_mha_bwd_dkv.restype = i
    # x, g, b, y, then (rows, D, eps, dtype)
    lib.layer_norm_fwd.argtypes = [p] * 4 + [l, i, ctypes.c_float, i, p]
    lib.layer_norm_fwd.restype = i
    # x, g, dy, dx, the two [blocks, D] partials, dg, db, then (rows, D, eps, dtype)
    lib.layer_norm_bwd.argtypes = [p] * 8 + [l, i, ctypes.c_float, i, p]
    lib.layer_norm_bwd.restype = i
    lib.layer_norm_bwd_block_rows.argtypes = []
    lib.layer_norm_bwd_block_rows.restype = i
    # qkv, out, then (B, N, H, Dh, dtype, mode)
    lib.clip_mha_decomp.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.clip_mha_decomp.restype = i
    # dy, argmax, dx, then (mode, dtype), x's (N, C, D, H, W), the output's (D, H, W), kernel, stride and padding (d, h, w),
    # the (n, c, d, h, w) strides of dy, argmax and dx, channels_last
    lib.pool3d_bwd.argtypes = [p] * 3 + [i] * 2 + [l] * 5 + [i] * 12 + [l] * 15 + [i, p]
    lib.pool3d_bwd.restype = i
    lib.attn_fwd_single_block_max.argtypes = []
    lib.attn_fwd_single_block_max.restype = i
    lib.attn_bwd_resident_max.argtypes = []
    lib.attn_bwd_resident_max.restype = i
    lib.clip_kernels_error_string.argtypes = [i]
    lib.clip_kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().clip_kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
