"""The card a run measures on.  A run that finds fewer cards than its cell
asks for fails: it never falls back to the CPU."""

from __future__ import annotations

import torch


class NoCard(RuntimeError):
    pass


def require(count: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} cards, "
                     f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def describe(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}

