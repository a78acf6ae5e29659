"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit)."""

from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(device_name: str) -> dict:
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no published peaks for {device_name!r}; known: {sorted(PEAKS)}") from None


def least_seconds(nbytes: float, ops: list, peaks: dict) -> float:
    """The larger of the bytes over the memory rate and the time of the
    arithmetic, each part ``(operations, peak key)`` at its own peak: the
    least time the card could take."""
    return max(nbytes / peaks["hbm_bytes_per_s"], sum(n / peaks[key] for n, key in ops))
