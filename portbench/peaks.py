"""Published peaks of the cards the benchmark runs on (dense rates, no sparsity).

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): 989 TFLOP/s bf16 / fp16 on the tensor cores,
67 TFLOP/s fp32 outside them, 3.35 TB/s of HBM3, 80 GB.  The rates assume the card's full
700 W power limit; the run reports the limit it found beside them.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12, "memory_bytes": 80e9},
}


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name`` (torch.cuda.get_device_name())."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peaks for {device_name!r}; known: {sorted(PEAKS)}")


def bound_s(bytes_moved: float, operations: float, peak: dict, ops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of bytes over bandwidth and operations over rate."""
    return max(bytes_moved / peak["hbm_bytes_per_s"], operations / peak[ops_key])
