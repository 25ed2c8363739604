"""Segmentation and panoptic heads with their losses (counterpart of
``ecs_yolo_tpu/nn/segment.py``; reference models/yolo_snn.py:450-497,
utils/segment/loss_tal.py, utils/panoptic/loss_tal.py).

The heads are ``DDetect``'s spiking towers plus a mask branch, each
collapsed over T by a mean, on the same ``[T, N, H, W, C]`` features as
every other head:

* ``Proto``: conv -> nearest 2x upsample -> conv -> 1x1, the ``nm`` mask
  prototypes ``[N, ph, pw, nm]`` at twice the first level's side;
* ``Segment``: the DFL box and class towers (``cv2_i``, ``cv3_i``), a mask
  coefficient tower a level (``cv4_i_0``, ``cv4_i_1``: spiking ``Conv``;
  ``cv4_i_2``: a 1x1 to ``nm``) and ``proto``.  Training output ``(feats,
  mc [N, nm, A], protos)``; eval ``(cat(y [N, 4+nc, A], mc) [N, 4+nc+nm, A],
  (feats, mc, protos))``;
* ``UConv`` and ``Panoptic``: ``Segment`` as ``seg`` plus a semantic branch
  ``uconv`` over the first level, ``[N, 2*h0, 2*w0, sem_nc + nc]`` logits,
  appended to both outputs.

Module names are the JAX package's (``proto``, ``cv4_0_1``, ``seg``,
``uconv``), so ``models/convert.py`` maps the JAX tree path for path.

Losses, as JAX computes them: ``segment_mask_loss`` (BCE of the prototype
masks against the assigned instance mask, cropped to the assigned box and
normalised by its area), ``compute_loss_segment`` (the TAL terms with their
fixed gains (7.5, 0.5, 1.5), whatever the hyp says, plus the mask term),
``semantic_loss`` (sigmoid focal + global dice on the channel softmax) and
``compute_loss_panoptic``.  A mask or id map at another size than the
prototypes / logits is resized with JAX's ``jax.image.resize(...,
"nearest")`` indexing (``resize_nearest``: half-pixel centres, not
``F.interpolate``'s ``nearest``).  Inside ``parallel/mesh.data_parallel``
each loss is this rank's part of the global batch's (the foreground count
summed over the data ranks, the focal mean over the global batch, the dice
of the global sums), as in ``train/loss_tal.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..config import DEFAULT_SNN, SNNConfig
from ..parallel import mesh
from .blocks import DFL, Conv, Sample, SnnConv
from .heads import _add_branch, _DFLHead, _mean_t, _run_branch


class Proto(nn.Module):
    """Mask prototypes (reference Proto): conv -> up 2x -> conv -> 1x1, the
    mean over T.  ``[T, N, h, w, c1]`` -> ``[N, 2h, 2w, nm]``."""

    def __init__(self, c1: int, npr: int = 256, nm: int = 32,
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.cv1 = Conv(c1, npr, 3, snn=snn)
        self.up = Sample(None, 2, "nearest")
        self.cv2 = Conv(npr, npr // 2, 3, snn=snn)
        self.cv3 = Conv(npr // 2, nm, 1, snn=snn)

    def forward(self, x):
        return _mean_t(self.cv3(self.cv2(self.up(self.cv1(x)))))


class Segment(_DFLHead):
    """Instance segmentation head: ``DDetect`` + mask coefficients +
    prototypes."""

    def __init__(self, nc: int, nm: int, npr: int, reg_max: int,
                 strides: Sequence[float], ch: Sequence[int],
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__(nc, reg_max, strides)
        self.nm = nm
        c4 = max(ch[0] // 4, nm)
        self.proto = Proto(ch[0], npr, nm, snn)
        _add_branch(self, ch, "", nc, reg_max, snn)
        for i, c in enumerate(ch):
            self.add_module(f"cv4_{i}_0", Conv(c, c4, 3, snn=snn))
            self.add_module(f"cv4_{i}_1", Conv(c4, c4, 3, snn=snn))
            self.add_module(f"cv4_{i}_2", SnnConv(c4, nm, 1, bias=True))
        self.dfl = DFL(reg_max)

    def forward(self, xs):
        protos = self.proto(xs[0])
        feats = _run_branch(self, xs, "")
        mcs = []
        for i, x in enumerate(xs):
            m = getattr(self, f"cv4_{i}_1")(getattr(self, f"cv4_{i}_0")(x))
            m = _mean_t(getattr(self, f"cv4_{i}_2")(m))            # [N, h, w, nm]
            mcs.append(m.reshape(m.shape[0], -1, self.nm).permute(0, 2, 1))
        mc = torch.cat(mcs, dim=2)                                   # [N, nm, A]
        if self.training:
            return feats, mc, protos
        return torch.cat([self.decode(feats, self.dfl), mc], dim=1), (feats, mc, protos)


class UConv(nn.Module):
    """Semantic upsampling conv (reference UConv): conv -> up 2x -> 1x1
    with bias, the mean over T."""

    def __init__(self, c1: int, c_hidden: int, c_out: int, snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.cv1 = Conv(c1, c_hidden, 3, snn=snn)
        self.up = Sample(None, 2, "nearest")
        self.cv2 = SnnConv(c_hidden, c_out, 1, bias=True)

    def forward(self, x):
        return _mean_t(self.cv2(self.up(self.cv1(x))))


class Panoptic(nn.Module):
    """Panoptic head (reference models/yolo_snn.py:473-497): ``Segment``
    (``seg``) plus the semantic branch ``uconv`` over the first level, with
    ``sem_nc + nc`` classes."""

    def __init__(self, nc: int, sem_nc: int, nm: int, npr: int, reg_max: int,
                 strides: Sequence[float], ch: Sequence[int],
                 snn: SNNConfig = DEFAULT_SNN):
        super().__init__()
        self.nc, self.strides = nc, [float(s) for s in strides]
        self.seg = Segment(nc, nm, npr, reg_max, strides, ch, snn)
        self.uconv = UConv(ch[0], ch[0] // 4, sem_nc + nc, snn)

    def forward(self, xs):
        sem = self.uconv(xs[0])
        out = self.seg(xs)
        if self.training:
            return (*out, sem)
        y, aux = out
        return y, (*aux, sem)


# --- losses ------------------------------------------------------------------------


def resize_nearest(x: torch.Tensor, hw: Tuple[int, int],
                   axes: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """The two ``axes`` of ``x`` (the last two by default) resized to ``hw``
    by nearest neighbour as ``jax.image.resize(..., "nearest")`` indexes:
    output ``i`` reads input ``floor((i + 0.5) * m / n)``, computed in
    float32."""
    for d, n in zip(axes, hw):
        m = x.shape[d]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n)
        x = x.index_select(d, idx.floor().to(torch.int64).clamp(max=m - 1))
    return x


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """``masks`` ``[N, h, w]`` zeroed outside the xyxy ``boxes`` ``[N, 4]``
    (mask coordinates; reference utils/segment/general.py)."""
    h, w = masks.shape[1:3]
    ys = torch.arange(h, dtype=boxes.dtype, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=boxes.dtype, device=masks.device)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i][:, None, None] for i in range(4))
    keep = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * keep


def segment_mask_loss(mc: torch.Tensor, protos: torch.Tensor, fg_mask: torch.Tensor,
                      target_gt_idx: torch.Tensor, gt_masks: torch.Tensor,
                      target_bboxes: torch.Tensor, stride0: float) -> torch.Tensor:
    """Prototype mask BCE (reference utils/segment/loss_tal.py): the logits
    ``protos @ mc`` ``[N, A, ph, pw]`` against each anchor's assigned gt mask
    (``gt_masks`` ``[N, M, ph, pw]``, row ``target_gt_idx``), cropped to the
    assigned box (``target_bboxes`` xyxy in input pixels, ``2 / stride0``
    to mask pixels), summed, divided by the box's area (at least 1), meaned
    over the foreground anchors."""
    n, ph, pw, _ = protos.shape
    pred = torch.einsum("nhwm,nma->nahw", protos, mc)
    a = pred.shape[1]
    tgt = gt_masks[torch.arange(n, device=gt_masks.device)[:, None], target_gt_idx]
    bce = pred.clamp(min=0) - pred * tgt + torch.log1p(torch.exp(-pred.abs()))
    boxes_m = target_bboxes * (2.0 / stride0)
    crop = crop_mask(bce.reshape(n * a, ph, pw), boxes_m.reshape(-1, 4)).reshape(bce.shape)
    area = ((boxes_m[..., 2] - boxes_m[..., 0])
            * (boxes_m[..., 3] - boxes_m[..., 1])).clamp(min=1.0)
    per_anchor = crop.sum((2, 3)) / area
    return (torch.where(fg_mask, per_anchor, 0.0).sum()
            / mesh.data_sum(fg_mask.sum()).clamp(min=1))


def compute_loss_segment(out, targets, t_mask, gt_masks, strides: Sequence[float],
                         nc: int, mask_gain: float = 2.5):
    """Detection + prototype mask loss of a training output ``(feats, mc,
    protos[, sem])`` (reference utils/segment/loss_tal.py:170-252): the TAL
    terms at their default gains (7.5, 0.5, 1.5), as JAX calls
    ``compute_loss_tal``, and the mask term times ``mask_gain``.
    ``gt_masks`` ``[B, M, h, w]`` are resized to the prototypes' size.
    Returns ``(total * B, (box, mask, cls, dfl))``."""
    from ..train.loss_tal import compute_loss_tal

    feats, mc, protos = out[0], out[1], out[2]
    b = mesh.global_batch(feats[0].shape[0])
    det_total, det_items, assign = compute_loss_tal(feats, targets, t_mask, strides, nc,
                                                    return_assign=True)
    ph, pw = protos.shape[1:3]
    gt_masks = resize_nearest(gt_masks.to(protos.dtype), (ph, pw))
    img_h, _ = assign["img_hw"]
    lm = segment_mask_loss(mc, protos, assign["fg_mask"], assign["target_gt_idx"],
                           gt_masks, assign["target_bboxes_px"],
                           float(img_h / ph * 2.0)) * mask_gain
    items = torch.stack([det_items[0], lm.detach(), det_items[1], det_items[2]])
    return det_total + lm * b, items


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (torchvision's, the reference's
    semantic term, utils/panoptic/loss_tal.py:262)."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def semantic_loss(sem_logits: torch.Tensor, sem_gt: torch.Tensor):
    """The semantic terms of the panoptic loss (reference
    utils/panoptic/loss_tal.py:252-272): sigmoid focal (alpha 0.25, gamma 2,
    mean) and a global dice on the channel softmax of ``sem_logits`` ``[B,
    Hs, Ws, C]`` against the class-id map ``sem_gt`` ``[B, hs, ws]`` (resized
    to the logits), one-hot in the logits' dtype; an id outside ``[0, C)``
    (background -1) is an all-zero row, as ``jax.nn.one_hot`` makes it.
    Returns ``(focal, dice)`` at the reference's gains (x20 / 2 x2.5 and / 2
    x2.5)."""
    c = sem_logits.shape[-1]
    sem_gt = resize_nearest(sem_gt, tuple(sem_logits.shape[1:3]))
    gt = (sem_gt[..., None] == torch.arange(c, device=sem_gt.device)).to(sem_logits.dtype)
    focal = mesh.global_mean(sigmoid_focal_loss(sem_logits, gt)) / 2.0
    p = torch.softmax(sem_logits, dim=-1)
    inter, total = (p * gt).sum(), (p + gt).sum()
    if mesh.data_size() > 1:
        # the global dice on every rank; its gradient reaches each rank's sums
        # through the all-reduce's backward, which sums it over the ranks, so
        # each rank's part is the term over the data ranks
        inter, total = mesh.data_sum_grad(torch.stack([inter, total]))
    dice = (2.0 * inter + 1.0) / (total + 1.0)
    return focal * 20.0 * 2.5, (1.0 - dice) / 2.0 * 2.5 / mesh.data_size()


def compute_loss_panoptic(out, targets, t_mask, gt_masks, sem_gt, strides: Sequence[float],
                          nc: int, mask_gain: float = 2.5):
    """``compute_loss_segment`` plus the semantic terms over the ``uconv``
    logits ``out[3]``, taken in float32 as JAX takes them (reference
    utils/panoptic/loss_tal.py:183-280).  Returns ``(total * B, (box, mask,
    cls, dfl, sem_focal, sem_dice))``."""
    det_total, det_items = compute_loss_segment(out, targets, t_mask, gt_masks, strides,
                                                nc, mask_gain=mask_gain)
    b = mesh.global_batch(out[0][0].shape[0])
    lf, ld = semantic_loss(out[3].to(torch.float32), sem_gt)
    items = torch.cat([det_items, torch.stack([lf.detach(), ld.detach()]).to(det_items.dtype)])
    return det_total + (lf + ld) * b, items
