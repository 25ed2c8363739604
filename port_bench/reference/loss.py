"""The v1 anchor loss of the detector (the reference's ``utils/loss.py``
``ComputeLoss`` with SIoU boxes, written out plainly).

Targets arrive padded: ``[B, M, 5]`` (cls, cx, cy, w, h, normalised) with a
validity mask ``[B, M]``.  Per level every valid target is assigned to its
cell and the two neighbour cells nearer its centre (offset 0.5), for every
anchor whose width and height ratios to it stay under ``anchor_t``; box
loss ``1 - SIoU`` and class BCE are averaged over the assignments, the
objectness BCE over all cells against the assignments' detached IoU (the
largest where several land in one cell), weighted per level (4, 1 for two
levels).  Returns ``((lbox + lobj + lcls) * B, [lbox, lobj, lcls])`` with the
hyper-parameters' gains applied.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


def siou(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SIoU of (cx, cy, w, h) boxes ``[n, 4]``."""
    p1, p2 = p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2
    t1, t2 = t[:, :2] - t[:, 2:] / 2, t[:, :2] + t[:, 2:] / 2
    inter = (torch.minimum(p2, t2) - torch.maximum(p1, t1)).clamp(min=0).prod(1)
    w1, h1 = p2[:, 0] - p1[:, 0], p2[:, 1] - p1[:, 1] + eps
    w2, h2 = t2[:, 0] - t1[:, 0], t2[:, 1] - t1[:, 1] + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(p2[:, 0], t2[:, 0]) - torch.minimum(p1[:, 0], t1[:, 0])
    ch = torch.maximum(p2[:, 1], t2[:, 1]) - torch.minimum(p1[:, 1], t1[:, 1])
    s_cw = (t1[:, 0] + t2[:, 0] - p1[:, 0] - p2[:, 0]) * 0.5 + eps
    s_ch = (t1[:, 1] + t2[:, 1] - p1[:, 1] - p2[:, 1]) * 0.5 + eps
    sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2)
    sin1, sin2 = s_cw.abs() / sigma, s_ch.abs() / sigma
    sin_a = torch.where(sin1 > math.sqrt(2) / 2, sin2, sin1)
    angle = torch.cos(torch.asin(sin_a.clamp(-1, 1)) * 2 - math.pi / 2)
    g = angle - 2
    dist = 2 - torch.exp(g * (s_cw / cw) ** 2) - torch.exp(g * (s_ch / ch) ** 2)
    ow = (w1 - w2).abs() / torch.maximum(w1, w2)
    oh = (h1 - h2).abs() / torch.maximum(h1, h2)
    shape = (1 - torch.exp(-ow)) ** 4 + (1 - torch.exp(-oh)) ** 4
    return iou - (0.5 * (dist + shape) + eps)


def _bce(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logit, target, reduction="none")


def v1_loss(maps: Sequence[torch.Tensor], targets: torch.Tensor, mask: torch.Tensor,
            anchors_px: Sequence[Sequence[float]], strides: Sequence[float],
            hyp: Dict[str, float], nc: int):
    """``maps``: per level ``[B, na, ny, nx, 5 + nc]`` raw outputs."""
    balance = [4.0, 1.0, 0.4][:len(maps)] if len(maps) <= 3 else None
    bs = maps[0].shape[0]
    lbox = lobj = lcls = maps[0].new_zeros(())
    for i, pi in enumerate(maps):
        _, na, ny, nx, _ = pi.shape
        anchors = torch.tensor(anchors_px[i], dtype=pi.dtype, device=pi.device).view(na, 2) \
            / strides[i]
        b_idx, m_idx = torch.nonzero(mask, as_tuple=True)
        t = targets[b_idx, m_idx]                                  # [n, 5]
        gxy = t[:, 1:3] * torch.tensor([nx, ny], dtype=pi.dtype, device=pi.device)
        gwh = t[:, 3:5] * torch.tensor([nx, ny], dtype=pi.dtype, device=pi.device)
        rows = []
        for a in range(na):
            r = gwh / anchors[a]
            ok_a = torch.maximum(r, 1 / r).amax(1) < hyp["anchor_t"]
            gxi = torch.tensor([nx, ny], dtype=pi.dtype, device=pi.device) - gxy
            near = [torch.ones_like(ok_a),
                    (gxy[:, 0] % 1 < 0.5) & (gxy[:, 0] > 1), (gxy[:, 1] % 1 < 0.5) & (gxy[:, 1] > 1),
                    (gxi[:, 0] % 1 < 0.5) & (gxi[:, 0] > 1), (gxi[:, 1] % 1 < 0.5) & (gxi[:, 1] > 1)]
            for o, (ox, oy) in enumerate(OFFSETS):
                sel = torch.nonzero(ok_a & near[o], as_tuple=True)[0]
                off = torch.tensor([ox, oy], dtype=pi.dtype, device=pi.device) * 0.5
                gij = torch.floor(gxy[sel] - off)
                gi = gij[:, 0].clamp(0, nx - 1).long()
                gj = gij[:, 1].clamp(0, ny - 1).long()
                rows.append((b_idx[sel], torch.full_like(gi, a), gj, gi, t[sel, 0].long(),
                             torch.cat([gxy[sel] - torch.stack([gi, gj], 1).to(pi.dtype),
                                        gwh[sel]], 1),
                             anchors[a].expand(len(sel), 2)))
        b, a, gj, gi, tcls, tbox, anch = (torch.cat(c) for c in zip(*rows))
        ps = pi[b, a, gj, gi]
        pbox = torch.cat([torch.sigmoid(ps[:, :2]) * 2 - 0.5,
                          (torch.sigmoid(ps[:, 2:4]) * 2) ** 2 * anch], 1)
        iou = siou(pbox, tbox)
        n = max(len(b), 1)
        lbox = lbox + (1.0 - iou).sum() / n
        # several assignments to one cell: the largest IoU wins
        flat = ((b * na + a) * ny + gj) * nx + gi
        tobj = pi.new_zeros(pi.shape[:4]).view(-1).scatter_reduce(
            0, flat, iou.detach().clamp(min=0), "amax", include_self=True).view(pi.shape[:4])
        lobj = lobj + _bce(pi[..., 4], tobj).mean() * balance[i]
        if nc > 1:
            tc = torch.zeros_like(ps[:, 5:])
            tc[torch.arange(len(tcls), device=pi.device), tcls.clamp(0, nc - 1)] = 1.0
            lcls = lcls + _bce(ps[:, 5:], tc).sum() / (n * nc)
    lbox, lobj, lcls = lbox * hyp["box"], lobj * hyp["obj"], lcls * hyp["cls"]
    return (lbox + lobj + lcls) * bs, torch.stack([lbox, lobj, lcls]).detach()
