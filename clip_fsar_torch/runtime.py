"""Device selection and numeric defaults for the port."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from clip_fsar_torch.parallel import mesh


def device(kind: Optional[str] = None) -> torch.device:
    """The device the port runs on: ``cuda`` unless the caller names
    another, and under a process group this rank's card
    (``parallel.mesh.local_rank``).  Without a card ``cuda`` raises; only
    ``device("cpu")`` gives the CPU -- the port never falls back to it
    silently.

    Also turns TF32 off for matmuls and cuDNN convolutions, so float32 runs
    are true float32 (the JAX reference parity tests run at
    ``jax_default_matmul_precision=highest``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if kind is None else kind)
    if dev.type == "cuda" and dev.index is None and mesh.distributed():
        dev = torch.device("cuda", mesh.local_rank())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the port runs on device {str(dev)!r} but torch sees no CUDA device; "
                           "ask for the CPU by name (device 'cpu', --device cpu on the CLI)")
    return dev


@contextlib.contextmanager
def deterministic_convolutions():
    """Inside the block (or the function it decorates) cuDNN takes only the
    convolution algorithms that give the same bits on every run.  Otherwise
    its heuristics may pick a backward that cuDNN marks nondeterministic, and
    then a train step does not repeat bit for bit (a fp32 MoSI step of 4
    frames did not).  The train steps of the few-shot and the classification tasks run
    under it: their forward and backward both happen inside the step call.
    The flag is restored on exit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
