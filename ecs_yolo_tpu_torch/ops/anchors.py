"""Anchor grids (counterpart of ``ecs_yolo_tpu/ops/anchors.py``)."""

from __future__ import annotations

import torch


def make_grid_v1(nx: int, ny: int, na: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """v1 anchor-based grid (reference models/yolo.py:150-161): integer cell
    coordinates broadcast over anchors -> [1, na, ny, nx, 2]."""
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=dtype, device=device),
                            torch.arange(nx, dtype=dtype, device=device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)
    return grid[None, None].expand(1, na, ny, nx, 2)
