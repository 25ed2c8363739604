"""Batch augmentation on the card (counterpart of
``ecs_yolo_tpu/data/device_augment.py``).

The host decodes and letterboxes; mosaic, geometry, HSV and the horizontal
flip run here on tensors that stay on the device, in plain torch (the JAX
module is plain XLA, not a kernel).  Images are ``[B, H, W, 3]`` float in
[0, 1]; labels ``[B, M, 5]`` (cls, cx, cy, w, h normalised) and masks
``[B, M]``.  A mosaic makes ``4M`` label rows.

Every random draw is split from its application.  A ``draw_*`` function
takes an explicit ``torch.Generator`` (on the images' device, so that no
draw is copied to the card) and makes small per-batch tensors: the mosaic
partners ``[B, 3]`` and centres ``[B, 2]``, the affine parameters ``[B,
6]``, ``s``/``tx``/``ty``/``flip`` ``[B]``, the HSV gains ``[B, 3]``.  The
``apply_*`` functions and ``_resample_core`` take those tensors, so the same
draws give the same batch (the tests feed JAX's own draws to them).  The
``random_*`` functions, ``mosaic4``, ``mosaic4_grid``,
``scale_translate_flip`` and ``augment_batch`` draw and apply, as the JAX
functions of those names do with a key.

``augment_batch`` takes the fast route (static 2x2 mosaic, one separable
scale/translate/flip resample, branchless HSV) when ``degrees``, ``shear``
and ``perspective`` are 0, else the generic one (mosaic around a random
centre, a gather warp, HSV, a flip with p 0.5), as JAX does.  The mosaic is
applied to the whole batch whenever ``mosaic > 0`` (JAX's, not the host's
per-sample roll).  ``check_hyp`` refuses ``flipud``, ``mixup`` and
``copy_paste`` above 0: this pipeline has none of them, and the JAX module
drops them without a word.

Nothing here reads a device value on the host, so a step that augments its
batch this way does not wait for the card.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

FILL = 114.0 / 255.0
#: hyps of the host pipeline that this one does not implement
UNSUPPORTED_HYPS = ("flipud", "mixup", "copy_paste")


def check_hyp(hyp: Mapping[str, float]) -> None:
    """Raise ``ValueError`` naming every hyp > 0 that the device pipeline
    would otherwise drop (``flipud``, ``mixup``, ``copy_paste``)."""
    bad = [k for k in UNSUPPORTED_HYPS if float(hyp.get(k, 0.0)) > 0]
    if bad:
        raise ValueError(
            f"device_augment has no {', '.join(bad)}: set {'/'.join(bad)} to 0 "
            "or augment on the host (device_augment=False)")


def _fast_geometry(hyp: Mapping[str, float]) -> bool:
    return all(float(hyp.get(k, 0.0)) == 0.0 for k in ("degrees", "shear", "perspective"))


# --- draws --------------------------------------------------------------------


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def draw_hsv_gains(b: int, gen: torch.Generator, hgain=0.015, sgain=0.7, vgain=0.4,
                   device=None) -> torch.Tensor:
    """``[B, 3]`` per-image gains ``1 + U(-1, 1) * (hgain, sgain, vgain)``."""
    u = _uniform(gen, (b, 3), -1.0, 1.0, device)
    return torch.stack([u[:, 0] * hgain, u[:, 1] * sgain, u[:, 2] * vgain], 1) + 1.0


def draw_partners(b: int, gen: torch.Generator, device=None) -> torch.Tensor:
    """``[B, 3]`` mosaic partners of each image, from the batch."""
    return torch.randint(0, b, (b, 3), generator=gen, device=device)


def draw_centers(b: int, gen: torch.Generator, device=None) -> torch.Tensor:
    """``[B, 2]`` (cy, cx) mosaic centres, canvas-normalised, U(0.4, 0.6)."""
    return _uniform(gen, (b, 2), 0.4, 0.6, device)


def draw_affine(b: int, gen: torch.Generator, degrees=0.0, translate=0.1, scale=0.5,
                shear=0.0, device=None) -> torch.Tensor:
    """``[B, 6]`` per-image affine draws: rotation and the two shears in
    degrees, the scale, and the translation as a fraction of the side
    (``affine_matrices`` composes them)."""
    return torch.stack([
        _uniform(gen, (b,), -degrees, degrees, device),
        _uniform(gen, (b,), 1 - scale, 1 + scale, device),
        _uniform(gen, (b,), -shear, shear, device),
        _uniform(gen, (b,), -shear, shear, device),
        _uniform(gen, (b,), 0.5 - translate, 0.5 + translate, device),
        _uniform(gen, (b,), 0.5 - translate, 0.5 + translate, device)], 1)


def draw_flip(b: int, gen: torch.Generator, p: float = 0.5, device=None) -> torch.Tensor:
    """``[B]`` bool: flip this image."""
    return torch.rand((b,), generator=gen, device=device) < p


def draw_scale_translate_flip(b: int, gen: torch.Generator, out_hw: Tuple[int, int],
                              translate=0.1, scale=0.5, fliplr=0.5, device=None):
    """``(s, tx, ty, flip)``, each ``[B]``: zoom, the output pixel the source
    centre lands on, and the flip."""
    h, w = out_hw
    s = _uniform(gen, (b,), 1 - scale, 1 + scale, device)
    tx = _uniform(gen, (b,), (0.5 - translate) * w, (0.5 + translate) * w, device)
    ty = _uniform(gen, (b,), (0.5 - translate) * h, (0.5 + translate) * h, device)
    return s, tx, ty, draw_flip(b, gen, fliplr, device)


# --- colour -------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    d = maxc - minc
    s = torch.where(maxc > 0, d / (maxc + 1e-12), 0.0)
    d_safe = torch.where(d == 0, 1.0, d)
    h = torch.where(maxc == r, torch.remainder((g - b) / d_safe, 6.0),
                    torch.where(maxc == g, (b - r) / d_safe + 2.0,
                                (r - g) / d_safe + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    return torch.stack([h, s, maxc], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.remainder(torch.floor(h).to(torch.int64), 6)
    f = h - torch.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    pick = lambda *opts: torch.gather(torch.stack(opts, -1), -1, i[..., None])[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def apply_hsv(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """HSV jitter with the gains ``r`` ``[B, 3]`` (the host ``augment_hsv``'s
    device form)."""
    hsv = rgb_to_hsv(images)
    g = r[:, None, None]
    h = torch.remainder(hsv[..., 0] * g[..., 0], 1.0)
    s = (hsv[..., 1] * g[..., 1]).clamp(0, 1)
    v = (hsv[..., 2] * g[..., 2]).clamp(0, 1)
    return hsv_to_rgb(torch.stack([h, s, v], -1))


def apply_hsv_fast(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``apply_hsv`` with the hue wheel written branch-free (no gather)."""
    rc, gc, bc = images[..., 0], images[..., 1], images[..., 2]
    maxc = torch.maximum(torch.maximum(rc, gc), bc)
    minc = torch.minimum(torch.minimum(rc, gc), bc)
    d = maxc - minc
    d_safe = torch.where(d == 0, 1.0, d)
    hh = torch.where(maxc == rc, torch.remainder((gc - bc) / d_safe, 6.0),
                     torch.where(maxc == gc, (bc - rc) / d_safe + 2.0,
                                 (rc - gc) / d_safe + 4.0))
    hh = torch.where(d == 0, 0.0, hh) / 6.0
    ss = torch.where(maxc > 0, d / (maxc + 1e-12), 0.0)
    g = r[:, None, None]
    hh = torch.remainder(hh * g[..., 0], 1.0)
    ss = (ss * g[..., 1]).clamp(0, 1)
    vv = (maxc * g[..., 2]).clamp(0, 1)

    def chan(n):
        k = torch.remainder(n + hh * 6.0, 6.0)
        return vv - vv * ss * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1)


def random_hsv(images, gen, hgain=0.015, sgain=0.7, vgain=0.4):
    return apply_hsv(images, draw_hsv_gains(images.shape[0], gen, hgain, sgain, vgain,
                                            images.device))


def random_hsv_fast(images, gen, hgain=0.015, sgain=0.7, vgain=0.4):
    return apply_hsv_fast(images, draw_hsv_gains(images.shape[0], gen, hgain, sgain,
                                                 vgain, images.device))


# --- geometry -----------------------------------------------------------------


def affine_matrices(draws: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``[B, 3, 3]`` matrices ``T @ Shear @ R @ Center`` (the host path's
    composition) from ``draw_affine``'s columns."""
    a = draws[:, 0] * math.pi / 180
    s = draws[:, 1]
    shx = torch.tan(draws[:, 2] * math.pi / 180)
    shy = torch.tan(draws[:, 3] * math.pi / 180)
    tx, ty = draws[:, 4] * w, draws[:, 5] * h
    ca, sa = s * torch.cos(a), s * torch.sin(a)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    mat = lambda *rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
    C = mat((one, zero, zero - w / 2), (zero, one, zero - h / 2), (zero, zero, one))
    R = mat((ca, sa, zero), (-sa, ca, zero), (zero, zero, one))
    S = mat((one, shx, zero), (shy, one, zero), (zero, zero, one))
    T = mat((one, zero, tx), (zero, one, ty), (zero, zero, one))
    return T @ S @ R @ C


def _warp(images: torch.Tensor, minv: torch.Tensor, fill: float = FILL) -> torch.Tensor:
    """Bilinear inverse warp of ``[B, H, W, 3]`` images with ``[B, 3, 3]``
    matrices: ``map_coordinates(order=1, mode="constant", cval=fill)`` per
    channel, each of the four corners outside the image contributing
    ``fill``, summed in JAX's corner order."""
    b, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(h, device=dev).repeat_interleave(w)
    xs = torch.arange(w, device=dev).repeat(h)
    coords = torch.stack([xs, ys, torch.ones_like(xs)], 0).to(torch.float32)
    src = minv @ coords                                  # [B, 3, HW]
    sx, sy = src[:, 0] / src[:, 2], src[:, 1] / src[:, 2]
    flat = images.reshape(b, h * w, c)
    bidx = torch.arange(b, device=dev)[:, None]
    nodes = []
    for coord, size in ((sy, h), (sx, w)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int32)
        nodes.append([(idx, 1 - upper_w), (idx + 1, upper_w)])
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            at = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            val = torch.where(ok[..., None], flat[bidx, at], fill)
            term = (wy * wx)[..., None] * val
            out = term if out is None else out + term
    return out.reshape(b, h, w, c)


def _warp_one(img: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    """``_warp`` of one ``[H, W, 3]`` image with one ``[3, 3]`` matrix."""
    return _warp(img[None], minv[None])[0]


def apply_affine(images, labels, masks, ms: torch.Tensor):
    """Warp each image with its affine ``ms`` ``[B, 3, 3]``, move the boxes'
    corners through it, and drop boxes under 2 px or with an aspect over 20
    (the host ``random_perspective``'s device form)."""
    b, h, w = images.shape[:3]
    out = _warp(images, torch.linalg.inv_ex(ms).inverse)   # no host check of info
    xy, wh = labels[..., 1:3], labels[..., 3:5]
    x1, y1 = (xy - wh / 2).unbind(-1)
    x2, y2 = (xy + wh / 2).unbind(-1)
    x1, x2, y1, y2 = x1 * w, x2 * w, y1 * h, y2 * h
    corners = torch.stack([x1, y1, x2, y1, x2, y2, x1, y2], -1).reshape(b, -1, 4, 2)
    pts = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)   # [B, M, 4, 3]
    warped = torch.einsum("bij,bmkj->bmki", ms, pts)
    wx, wy = warped[..., 0] / warped[..., 2], warped[..., 1] / warped[..., 2]
    nx1, nx2 = wx.amin(-1).clamp(0, w), wx.amax(-1).clamp(0, w)
    ny1, ny2 = wy.amin(-1).clamp(0, h), wy.amax(-1).clamp(0, h)
    bw, bh = nx2 - nx1, ny2 - ny1
    ok = masks & (bw > 2) & (bh > 2) & (bw / (bh + 1e-9) < 20) & (bh / (bw + 1e-9) < 20)
    new = torch.stack([labels[..., 0], (nx1 + nx2) / 2 / w, (ny1 + ny2) / 2 / h,
                       bw / w, bh / h], -1)
    return out, torch.where(ok[..., None], new, 0.0), ok


def random_affine(images, labels, masks, gen, degrees=0.0, translate=0.1, scale=0.5,
                  shear=0.0):
    b, h, w = images.shape[:3]
    draws = draw_affine(b, gen, degrees, translate, scale, shear, images.device)
    return apply_affine(images, labels, masks, affine_matrices(draws, w, h))


def apply_fliplr(images, labels, flip: torch.Tensor):
    """Mirror the images with ``flip`` ``[B]`` and their label x (every row,
    as JAX does)."""
    out = torch.where(flip[:, None, None, None], images.flip(2), images)
    lx = torch.where(flip[:, None], 1.0 - labels[..., 1], labels[..., 1])
    return out, torch.cat([labels[..., :1], lx[..., None], labels[..., 2:]], -1)


def random_fliplr(images, labels, gen, p: float = 0.5):
    return apply_fliplr(images, labels, draw_flip(images.shape[0], gen, p, images.device))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` weights of ``jax.image.resize(..., "bilinear")`` along
    one axis (triangle kernel, widened by the inverse scale when it shrinks,
    columns normalised)."""
    inv_scale = n_in / n_out
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / max(inv_scale, 1.0)
    wts = (1 - x.abs()).clamp(min=0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def apply_mosaic4(images, labels, masks, partners: torch.Tensor, ctr: torch.Tensor):
    """Image i with its 3 ``partners`` ``[B, 3]`` on a 2x canvas split at
    ``ctr`` ``[B, 2]`` (cy, cx), shrunk back to the input size (the host
    ``load_mosaic``'s device form).  As in JAX, a quadrant whose corner falls
    off the canvas is placed where JAX's slice update puts it (a negative
    start counts from the far edge, then every start is clamped so that the
    quadrant fits) while its labels keep the unmoved offset, and later
    quadrants overwrite earlier ones where they meet."""
    b, h, w, c = images.shape
    dev = images.device
    idx = torch.cat([torch.arange(b, device=dev)[:, None], partners], 1)   # [B, 4]
    cy, cx = ctr[:, 0] * 2 * h, ctr[:, 1] * 2 * w
    offs = torch.stack([torch.stack([cy - h, cx - w], -1), torch.stack([cy - h, cx], -1),
                        torch.stack([cy, cx - w], -1), torch.stack([cy, cx], -1)],
                       1).to(torch.int32)                                 # [B, 4, 2]
    # JAX's dynamic_update_slice: a negative start counts from the end, and
    # the start is then clamped so that the quadrant fits
    wrap = lambda o, n: torch.where(o < 0, o + 2 * n, o).clamp(0, n)
    starts = torch.stack([wrap(offs[..., 0], h), wrap(offs[..., 1], w)], -1)
    rows = torch.arange(2 * h, device=dev)
    cols = torch.arange(2 * w, device=dev)
    canvas = torch.full((b, 2 * h, 2 * w, c), FILL, dtype=images.dtype, device=dev)
    for q in range(4):
        ry = rows[None] - starts[:, q, 0:1]                               # [B, 2h]
        rx = cols[None] - starts[:, q, 1:2]                               # [B, 2w]
        inside = (((ry >= 0) & (ry < h))[:, :, None]
                  & ((rx >= 0) & (rx < w))[:, None, :])
        src = images[idx[:, q][:, None, None], ry.clamp(0, h - 1)[:, :, None],
                     rx.clamp(0, w - 1)[:, None, :]]
        canvas = torch.where(inside[..., None], src, canvas)
    wy = _resize_weights(2 * h, h, dev).to(images.dtype)
    wx = _resize_weights(2 * w, w, dev).to(images.dtype)
    small = torch.einsum("bHWc,Hh,Ww->bhwc", canvas, wy, wx)

    lq, mq = labels[idx], masks[idx]                                      # [B, 4, M, ...]
    oy = offs[..., 0].to(torch.float32)[:, :, None] / (2 * h)
    ox = offs[..., 1].to(torch.float32)[:, :, None] / (2 * w)
    new = torch.stack([lq[..., 0], lq[..., 1] * w / (2 * w) + ox,
                       lq[..., 2] * h / (2 * h) + oy, lq[..., 3] / 2, lq[..., 4] / 2],
                      -1).reshape(b, -1, 5)
    new_m = mq.reshape(b, -1)
    x1 = (new[..., 1] - new[..., 3] / 2).clamp(0, 1)
    y1 = (new[..., 2] - new[..., 4] / 2).clamp(0, 1)
    x2 = (new[..., 1] + new[..., 3] / 2).clamp(0, 1)
    y2 = (new[..., 2] + new[..., 4] / 2).clamp(0, 1)
    new = torch.stack([new[..., 0], (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    new_m = new_m & ((x2 - x1) > 2.0 / w) & ((y2 - y1) > 2.0 / h)
    return small, torch.where(new_m[..., None], new, 0.0), new_m


def mosaic4(images, labels, masks, gen):
    b = images.shape[0]
    partners = draw_partners(b, gen, images.device)
    return apply_mosaic4(images, labels, masks, partners,
                         draw_centers(b, gen, images.device))


def apply_mosaic4_grid(images, labels, masks, partners: torch.Tensor):
    """Static 2x2 stitch of image i with its ``partners`` ``[B, 3]``: the
    ``[B, 2H, 2W, 3]`` canvas, canvas-normalised labels ``[B, 4M, 5]`` and
    masks ``[B, 4M]``."""
    b = images.shape[0]
    idx = torch.cat([torch.arange(b, device=images.device)[:, None], partners], 1)
    quads = images[idx]                                                   # [B, 4, H, W, 3]
    canvas = torch.cat([torch.cat([quads[:, 0], quads[:, 1]], 2),
                        torch.cat([quads[:, 2], quads[:, 3]], 2)], 1)
    lq, mq = labels[idx], masks[idx]
    new = torch.stack([lq[..., 0], lq[..., 1] / 2 + _quadrant(lq, 1),
                       lq[..., 2] / 2 + _quadrant(lq, 2),
                       lq[..., 3] / 2, lq[..., 4] / 2], -1)
    m = lq.shape[2]
    new, new_m = new.reshape(b, 4 * m, 5), mq.reshape(b, 4 * m)
    return canvas, torch.where(new_m[..., None], new, 0.0), new_m


def _quadrant(like: torch.Tensor, axis: int) -> torch.Tensor:
    """``[1, 4, 1]`` canvas offsets of the four quadrants along x (axis 1)
    or y (axis 2), made on ``like``'s device without a host copy."""
    q = torch.arange(4, device=like.device)
    bit = q % 2 if axis == 1 else q // 2
    return (bit.to(like.dtype) * 0.5)[None, :, None]


def mosaic4_grid(images, labels, masks, gen):
    return apply_mosaic4_grid(images, labels, masks,
                              draw_partners(images.shape[0], gen, images.device))


def _resample_core(canvas, labels, masks, s, tx, ty, flip, out_hw, fill: float = FILL):
    """Per-image scale + translate (+ flip) resample ``[B, Hs, Ws, 3]`` ->
    ``[B, H, W, 3]`` as two batched tent-weight products (a dense separable
    bilinear), the labels through the same map.  The source centre lands on
    output pixel ``(ty, tx)`` at zoom ``s``; outside the source the output
    is ``fill`` (resampling ``canvas - fill`` and adding ``fill`` back)."""
    h, w = out_hw
    hs, ws = canvas.shape[1:3]
    cy, cx = hs / 2.0, ws / 2.0
    dev = canvas.device
    oy = torch.arange(h, dtype=torch.float32, device=dev)
    ox = torch.arange(w, dtype=torch.float32, device=dev)
    ox_eff = torch.where(flip[:, None], (w - 1.0) - ox[None, :], ox[None, :])
    uy = (oy[None, :] - ty[:, None]) / s[:, None] + cy                    # [B, h]
    ux = (ox_eff - tx[:, None]) / s[:, None] + cx                         # [B, w]
    iy = torch.arange(hs, dtype=torch.float32, device=dev)
    ix = torch.arange(ws, dtype=torch.float32, device=dev)
    wy = (1.0 - (uy[:, :, None] - iy).abs()).clamp(min=0.0)               # [B, h, Hs]
    wx = (1.0 - (ux[:, :, None] - ix).abs()).clamp(min=0.0)               # [B, w, Ws]
    src = canvas - fill
    tmp = torch.einsum("boi,biwc->bowc", wy, src)
    out = torch.einsum("bpj,bojc->bopc", wx, tmp) + fill

    sx, sy = labels[..., 1] * ws, labels[..., 2] * hs
    bw, bh = labels[..., 3] * ws * s[:, None], labels[..., 4] * hs * s[:, None]
    px = s[:, None] * (sx - cx) + tx[:, None]
    py = s[:, None] * (sy - cy) + ty[:, None]
    px = torch.where(flip[:, None], w - px, px)
    x1, x2 = (px - bw / 2).clamp(0, w), (px + bw / 2).clamp(0, w)
    y1, y2 = (py - bh / 2).clamp(0, h), (py + bh / 2).clamp(0, h)
    nw, nh = x2 - x1, y2 - y1
    ok = masks & (nw > 2) & (nh > 2) & (nw / (nh + 1e-9) < 20) & (nh / (nw + 1e-9) < 20)
    new = torch.stack([labels[..., 0], (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                       nw / w, nh / h], -1)
    return out, torch.where(ok[..., None], new, 0.0), ok


def scale_translate_flip(canvas, labels, masks, gen, out_hw, translate=0.1, scale=0.5,
                         fliplr=0.5):
    s, tx, ty, flip = draw_scale_translate_flip(canvas.shape[0], gen, out_hw, translate,
                                                scale, fliplr, canvas.device)
    return _resample_core(canvas, labels, masks, s, tx, ty, flip, out_hw)


# --- the pipeline ---------------------------------------------------------------


def draw_augment(b: int, out_hw: Tuple[int, int], gen: torch.Generator,
                 hyp: Mapping[str, float], device=None) -> Dict[str, torch.Tensor]:
    """Every draw of one ``augment_batch`` call on the route ``hyp`` selects:
    fast ``partners`` (when mosaic > 0), ``s``, ``tx``, ``ty``, ``flip``,
    ``hsv``; generic ``partners``, ``centers`` (mosaic > 0), ``affine``,
    ``hsv``, ``flip``."""
    h, w = out_hw
    mosaic = float(hyp.get("mosaic", 0.0)) > 0
    gains = (float(hyp.get("hsv_h", 0.015)), float(hyp.get("hsv_s", 0.7)),
             float(hyp.get("hsv_v", 0.4)))
    d: Dict[str, torch.Tensor] = {}
    if _fast_geometry(hyp):
        if mosaic:
            d["partners"] = draw_partners(b, gen, device)
        d["s"], d["tx"], d["ty"], d["flip"] = draw_scale_translate_flip(
            b, gen, out_hw, float(hyp.get("translate", 0.1)), float(hyp.get("scale", 0.5)),
            float(hyp.get("fliplr", 0.5)), device)
        d["hsv"] = draw_hsv_gains(b, gen, *gains, device=device)
        return d
    if mosaic:
        d["partners"] = draw_partners(b, gen, device)
        d["centers"] = draw_centers(b, gen, device)
    d["affine"] = draw_affine(b, gen, float(hyp.get("degrees", 0.0)),
                              float(hyp.get("translate", 0.1)), float(hyp.get("scale", 0.5)),
                              float(hyp.get("shear", 0.0)), device)
    d["hsv"] = draw_hsv_gains(b, gen, *gains, device=device)
    d["flip"] = draw_flip(b, gen, 0.5, device)
    return d


def apply_augment(images, labels, masks, draws: Mapping[str, torch.Tensor],
                  hyp: Mapping[str, float]):
    """The pipeline with ``draws`` (``draw_augment``'s): mosaic -> geometry ->
    HSV (-> flip on the generic route), clipped to [0, 1]."""
    h, w = images.shape[1:3]
    if not _fast_geometry(hyp):
        return _augment_batch_generic(images, labels, masks, draws, hyp)
    canvas = images
    if float(hyp.get("mosaic", 0.0)) > 0:
        canvas, labels, masks = apply_mosaic4_grid(images, labels, masks, draws["partners"])
    images, labels, masks = _resample_core(canvas, labels, masks, draws["s"], draws["tx"],
                                           draws["ty"], draws["flip"], (h, w))
    return apply_hsv_fast(images, draws["hsv"]).clamp(0, 1), labels, masks


def _augment_batch_generic(images, labels, masks, draws: Mapping[str, torch.Tensor],
                           hyp: Mapping[str, float]):
    """Generic route: mosaic -> gather warp -> HSV -> flip."""
    if float(hyp.get("mosaic", 0.0)) > 0:
        images, labels, masks = apply_mosaic4(images, labels, masks, draws["partners"],
                                              draws["centers"])
    h, w = images.shape[1:3]
    images, labels, masks = apply_affine(images, labels, masks,
                                         affine_matrices(draws["affine"], w, h))
    images = apply_hsv(images, draws["hsv"])
    images, labels = apply_fliplr(images, labels, draws["flip"])
    return images.clamp(0, 1), labels, masks


def augment_batch(images, labels, masks, gen: torch.Generator, hyp: Mapping[str, float]):
    """Draw from ``gen`` and augment the batch (``check_hyp`` first)."""
    check_hyp(hyp)
    draws = draw_augment(images.shape[0], tuple(images.shape[1:3]), gen, hyp,
                         images.device)
    return apply_augment(images, labels, masks, draws, hyp)
