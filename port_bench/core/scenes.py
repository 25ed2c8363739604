"""Seeded dashcam-like frames, made on the card, letterboxed to the served
size as the program's loaders do (``data/augment.letterbox``, no stride
rounding): a native ``H x W`` frame scaled by ``min(size/H, size/W)`` and
padded with grey 114 equally on both sides.

A frame is a sky over a road with a horizon between 40 % and 60 % of the
height, and 8 to 32 boxes of random colour standing on the road ("vehicles",
their size growing toward the bottom of the frame), with a little noise.
Only the layout follows the seed: every seed gives the same number of
frames at the same size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def letterbox_geometry(native_hw: Tuple[int, int], size: int):
    """``(gain, (new_h, new_w), (top, left))`` of the letterbox."""
    h, w = native_hw
    gain = min(size / h, size / w)
    nh, nw = int(round(h * gain)), int(round(w * gain))
    return gain, (nh, nw), ((size - nh) // 2, (size - nw) // 2)


def make_frames(n: int, seed: int, device, native_hw=(720, 1280), size: int = 640,
                max_objects: int = 32) -> torch.Tensor:
    """uint8 ``[n, size, size, 3]`` letterboxed frames on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    r = lambda *s: torch.rand(*s, generator=g, device=device)
    h, w = native_hw
    yy = torch.linspace(0, 1, h, device=device).view(1, 1, h, 1)
    xx = torch.linspace(0, 1, w, device=device).view(1, 1, 1, w)
    horizon = (0.4 + 0.2 * r(n)).view(n, 1, 1, 1)
    sky = 0.45 + 0.5 * r(n, 3, 1, 1)
    road = (0.25 + 0.25 * r(n, 1, 1, 1)).expand(n, 3, 1, 1)
    img = torch.where(yy < horizon, sky * (1 - 0.4 * yy), road * (0.7 + 0.3 * yy))
    k = 8 + (r(n) * (max_objects - 7)).long().clamp(max=max_objects)
    for j in range(max_objects):
        base = horizon.view(n) + (1 - horizon.view(n)) * r(n)         # where it stands
        bh = (0.04 + 0.3 * r(n)) * (base - horizon.view(n) + 0.05)
        bw = bh * (h / w) * (0.8 + 1.6 * r(n))
        x0 = r(n) * (1 - bw)
        on = ((xx >= x0.view(n, 1, 1, 1)) & (xx < (x0 + bw).view(n, 1, 1, 1))
              & (yy >= (base - bh).view(n, 1, 1, 1)) & (yy < base.view(n, 1, 1, 1))
              & (j < k).view(n, 1, 1, 1))
        img = torch.where(on, r(n, 3, 1, 1), img)
    img = (img + 0.025 * torch.randn(img.shape, generator=g, device=device)).clamp(0, 1)
    _, (nh, nw), (top, left) = letterbox_geometry(native_hw, size)
    img = F.interpolate(img, size=(nh, nw), mode="bilinear", antialias=True,
                        align_corners=False)
    out = torch.full((n, 3, size, size), 114 / 255, device=device)
    out[:, :, top:top + nh, left:left + nw] = img
    return (out * 255).round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
