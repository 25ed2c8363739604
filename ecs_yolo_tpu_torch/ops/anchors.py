"""Anchor grids and the box/distance transforms of the anchor-free heads
(counterpart of ``ecs_yolo_tpu/ops/anchors.py``).  Everything runs in the
dtype it is given, as the JAX functions do."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
                 grid_cell_offset: float = 0.5, dtype=torch.float32,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-centre anchor points of every level: ``[A, 2]`` (x, y in grid
    units) and the stride of each, ``[A, 1]``."""
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points, 0), torch.cat(stride_list, 0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True, dim: int = -1) -> torch.Tensor:
    """ltrb distances -> boxes (xywh or xyxy) along ``dim``."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: float) -> torch.Tensor:
    """xyxy boxes -> ltrb distances, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return d.clamp(0, reg_max - 0.01)


def make_grid_v1(nx: int, ny: int, na: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """v1 anchor-based grid (reference models/yolo.py:150-161): integer cell
    coordinates broadcast over anchors -> [1, na, ny, nx, 2]."""
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=dtype, device=device),
                            torch.arange(nx, dtype=dtype, device=device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)
    return grid[None, None].expand(1, na, ny, nx, 2)
