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
import time

from clip_fsar_torch.utils import tracing
from clip_fsar_torch.utils.logging import get_logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_LIB_NAME = "libclip_fsar_kernels.so"
logger = get_logger(__name__)


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


def library_path() -> str:
    """Where the library of this source/header/flag combination lives, built or not."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], _LIB_NAME)


def build() -> str:
    """Compile the kernels if this source/header/flag combination has no
    library yet; returns the library path.  The compilers' ``-Xptxas -v``
    report (registers, shared memory, spills per kernel) is kept as
    ``nvcc.log`` beside it."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    out_dir = os.path.dirname(lib_path)
    srcs = sources()
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
    point's argument and result types declared.  Logs whether it was built
    or found, and in how many seconds."""
    t0 = time.perf_counter()
    with tracing.setup_span("fsar.setup.kernels") as span:
        built = not os.path.exists(library_path())
        lib = ctypes.CDLL(build())
        span.set(built=built)
    logger.info("kernel library %s in %.1f s", "built" if built else "loaded from cache", time.perf_counter() - t0)
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
    # dy, argmax, dx, then (mode, dtype, vec) and the plan (24 ints in host memory: the channels-last view, the output's
    # extents, kernel, stride, padding, the tile and its box; ops/pool3d.py)
    lib.pool3d_bwd.argtypes = [p] * 3 + [i] * 3 + [ctypes.POINTER(i), p]
    lib.pool3d_bwd.restype = i
    # BMN's boundary-matching gathers: P, fwd_tile_rows, fwd_tile_row_ptr, fwd_tile_chunk_ptr, fwd_chunk_cut, fwd_ent, bias, out,
    # then (B, C3, N, T, D, the most entries of a chunk) and the tile the lists were built for (durations, starts, rows a chunk)
    lib.bm_gather_fwd.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.bm_gather_fwd.restype = i
    # out, dout, the [cells, B*C3] scratch, tile_cells, tile_cell_ptr, tile_chunk_ptr, chunk_cut, ent, dP, then (B, C3, N, T,
    # cells, the most entries of a chunk) and the tile the lists were built for (samples, positions, cells a chunk)
    lib.bm_gather_bwd.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.bm_gather_bwd.restype = i
    # the RN towers' BatchNorm: x, y, w, beta, running mean and var, the previous running stats (mean, var, group
    # stride), st, step, the partials, then G, M and the tile plan (C, vec, lanes, bands, rows, run, tiles), batch, eps,
    # the momentum's two factors and the dtype (ops/batch_norm.py)
    f = ctypes.c_float
    lib.batch_norm_fwd.argtypes = [p] * 8 + [l] + [p] * 3 + [i, l] + [i] * 8 + [f] * 3 + [i, p]
    lib.batch_norm_fwd.restype = i
    # x, dy, dx, w, running mean and var, st, co, the partials, dw, dbeta, then G, M, the plan, batch, eps and the dtype
    lib.batch_norm_bwd.argtypes = [p] * 11 + [i, l] + [i] * 8 + [f, i, p]
    lib.batch_norm_bwd.restype = i
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
