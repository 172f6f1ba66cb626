"""``paddle.vision.ops``: the detection ops, as torch programs.

Counterpart of ``paddle_tpu/vision/ops.py`` (``yolo_box``, ``yolo_loss``,
``prior_box``, ``box_coder``, ``multiclass_nms``, ``roi_align``,
``roi_pool``, ``generate_proposals``, ``distribute_fpn_proposals``,
``deform_conv2d``, ``DeformConv2D``).  Each op is a function of its
inputs' torch tensors run through the tracer's ``trace_fn``: eagerly it
runs on the inputs' device and autograd records it (``yolo_loss`` and
``deform_conv2d`` take their gradients that way), and in a static program
it is appended as the reference's one-off ``__pyfunc_<name>_<n>`` op.

The outputs keep the reference's static shapes: what Paddle returns as a
variable-length (LoD) result comes back padded, beside a count or an
index.  ``multiclass_nms`` gives ``[N, keep_top_k, 6]`` rows of (class,
score, x1, y1, x2, y2) with -1 rows after the kept ones, the count per
image and, with ``return_index``, each row's candidate index;
``generate_proposals`` gives ``[N, post_nms_top_n, 4]`` boxes with zero
rows after the kept ones, their scores and the count.  Candidates are
ordered by a stable sort on their scores, so of two equal scores the
lower index comes first, as ``jax.lax.top_k`` orders them.  The greedy
NMS walks the sorted candidates one at a time, as the reference's
``fori_loop`` does, with every image and class at once: each step is a
few tensor operations over masks on the device and reads nothing back
to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..nn.layer_base import Layer

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "prior_box", "box_coder", "multiclass_nms", "roi_align",
           "roi_pool", "distribute_fpn_proposals", "generate_proposals"]


def _trace(fn, tensors, name):
    from ..dygraph import tracer

    return tracer.trace_fn(fn, tensors, name=name)


def _sig(v):
    return 1.0 / (1.0 + torch.exp(-v))


def _top(scores, k):
    """The ``k`` largest scores along the last axis and their indices, in
    descending order; equal scores keep the lower index first."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _gather_rows(t, idx):
    """``t[b, idx[b, ...]]`` along axis 1 for every leading index ``b``."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(t, 1, flat[..., None].expand(-1, -1, t.shape[-1]))
    return out.reshape(*idx.shape, t.shape[-1])


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """YOLOv3's boxes and scores for every anchor and cell.

    x: [N, an*(5+cls), H, W]; img_size: [N, 2] (h, w).  Returns (boxes
    [N, an*H*W, 4], scores [N, an*H*W, cls]); a candidate whose
    confidence is below ``conf_thresh`` has zero box and scores.
    """
    an_num = len(anchors) // 2
    anchors = [float(a) for a in anchors]

    def fn(xa, imgs):
        n, c, h, w = xa.shape
        xa = xa.reshape(n, an_num, 5 + class_num, h, w)
        tx, ty, tw, th = xa[:, :, 0], xa[:, :, 1], xa[:, :, 2], xa[:, :, 3]
        tconf = xa[:, :, 4]
        tcls = xa[:, :, 5:]
        dt, dev = xa.dtype, xa.device
        gx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
        gy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
        img_h = imgs[:, 0].to(dt)[:, None, None, None]
        img_w = imgs[:, 1].to(dt)[:, None, None, None]
        in_w = float(downsample_ratio * w)
        in_h = float(downsample_ratio * h)
        bias = (scale_x_y - 1.0) * 0.5
        cx = (gx + _sig(tx) * scale_x_y - bias) / w * img_w
        cy = (gy + _sig(ty) * scale_x_y - bias) / h * img_h
        aw = torch.tensor(anchors[0::2], dtype=dt, device=dev)[
            None, :, None, None]
        ah = torch.tensor(anchors[1::2], dtype=dt, device=dev)[
            None, :, None, None]
        bw = torch.exp(tw) * aw * img_w / in_w
        bh = torch.exp(th) * ah * img_h / in_h
        x1 = cx - bw * 0.5
        y1 = cy - bh * 0.5
        x2 = cx + bw * 0.5
        y2 = cy + bh * 0.5
        if clip_bbox:
            zero = torch.zeros((), dtype=dt, device=dev)
            x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1.0)
            y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1.0)
            x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1.0)
            y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1.0)
        conf = _sig(tconf)
        keep = (conf >= conf_thresh).to(dt)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
        scores = _sig(tcls) * (conf * keep)[:, :, None]
        boxes = boxes.reshape(n, an_num * h * w, 4)
        scores = torch.movedim(scores, 2, -1).reshape(
            n, an_num * h * w, class_num)
        return boxes, scores

    return _trace(fn, [x, img_size], "yolo_box")


def _bce(logit, label):
    """Binary cross-entropy with logits, in its stable form."""
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _iou_cwh(cx1, cy1, w1, h1, cx2, cy2, w2, h2):
    l1, r1 = cx1 - w1 / 2, cx1 + w1 / 2
    t1, b1 = cy1 - h1 / 2, cy1 + h1 / 2
    l2, r2 = cx2 - w2 / 2, cx2 + w2 / 2
    t2, b2 = cy2 - h2 / 2, cy2 + h2 / 2
    iw = torch.clamp(torch.minimum(r1, r2) - torch.maximum(l1, l2), min=0)
    ih = torch.clamp(torch.minimum(b1, b2) - torch.maximum(t1, t2), min=0)
    inter = iw * ih
    return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's loss per image: location (BCE on x, y; L1 on w, h),
    objectness (BCE, predictions whose best IoU with a ground truth
    exceeds ``ignore_thresh`` ignored as negatives) and classification
    (BCE), each ground truth assigned to its best anchor by shape.

    x: [N, mask_num*(5+cls), H, W]; gt_box: [N, B, 4] (cx, cy, w, h,
    normalised); gt_label: [N, B] int.  Returns loss [N].
    """
    mask_num = len(anchor_mask)
    anchors_f = [float(a) for a in anchors]
    amask = [int(m) for m in anchor_mask]

    def fn(xa, gbox, glabel, *rest):
        gscore = rest[0] if rest else None
        n, c, h, w = xa.shape
        dt, dev = xa.dtype, xa.device
        xa = xa.reshape(n, mask_num, 5 + class_num, h, w)
        px, py = xa[:, :, 0], xa[:, :, 1]
        pw, ph = xa[:, :, 2], xa[:, :, 3]
        pobj = xa[:, :, 4]
        pcls = xa[:, :, 5:]
        gbox = gbox.to(dt)

        in_w = float(downsample_ratio * w)
        in_h = float(downsample_ratio * h)
        aw_all = torch.tensor(anchors_f[0::2], dtype=dt, device=dev)
        ah_all = torch.tensor(anchors_f[1::2], dtype=dt, device=dev)
        am = torch.tensor(amask, dtype=torch.long, device=dev)
        aw, ah = aw_all[am], ah_all[am]

        # predicted boxes (normalised) for the ignore-region IoU test
        gx = torch.arange(w, dtype=dt, device=dev)[None, None, :]
        gy = torch.arange(h, dtype=dt, device=dev)[None, :, None]
        pred_cx = (gx + _sig(px)) / w
        pred_cy = (gy + _sig(py)) / h
        pred_w = torch.exp(pw) * aw[None, :, None, None] / in_w
        pred_h = torch.exp(ph) * ah[None, :, None, None] / in_h

        B = gbox.shape[1]
        gw = gbox[:, :, 2]
        gh = gbox[:, :, 3]
        valid_gt = (gw > 0) & (gh > 0)

        # max IoU of each prediction against every ground truth
        ious = _iou_cwh(
            pred_cx[..., None], pred_cy[..., None],
            pred_w[..., None], pred_h[..., None],
            gbox[:, None, None, None, :, 0], gbox[:, None, None, None, :, 1],
            gw[:, None, None, None, :], gh[:, None, None, None, :])
        ious = torch.where(valid_gt[:, None, None, None, :], ious,
                           torch.zeros((), dtype=dt, device=dev))
        max_iou = torch.amax(ious, dim=-1)
        noobj_mask = (max_iou <= ignore_thresh).to(dt)

        # each ground truth's best anchor over all anchors, by shape IoU
        zero = torch.zeros((), dtype=dt, device=dev)
        shape_iou = _iou_cwh(
            zero, zero, gw[..., None] * in_w, gh[..., None] * in_h,
            zero, zero, aw_all[None, None, :], ah_all[None, None, :])
        best_a = torch.argmax(shape_iou, dim=-1)
        # its position in the anchor mask, or -1 outside this head's mask
        in_mask = torch.full(best_a.shape, -1, dtype=torch.long, device=dev)
        for mi, m in enumerate(amask):
            in_mask = torch.where(best_a == m, mi, in_mask)
        gi = torch.clamp((gbox[:, :, 0] * w).to(torch.int32), 0, w - 1).long()
        gj = torch.clamp((gbox[:, :, 1] * h).to(torch.int32), 0, h - 1).long()
        tx = gbox[:, :, 0] * w - gi
        ty = gbox[:, :, 1] * h - gj
        tw = torch.log(torch.clamp(gw * in_w, min=1e-10)
                       / torch.clamp(aw_all[best_a], min=1e-10))
        th = torch.log(torch.clamp(gh * in_h, min=1e-10)
                       / torch.clamp(ah_all[best_a], min=1e-10))
        scale = 2.0 - gw * gh
        use = valid_gt & (in_mask >= 0)
        sc = (gscore.to(dt) if gscore is not None
              else torch.ones(glabel.shape, dtype=dt, device=dev))

        smooth_pos = (1.0 - 1.0 / class_num if use_label_smooth
                      and class_num > 1 else 1.0)
        smooth_neg = (1.0 / class_num if use_label_smooth
                      and class_num > 1 else 0.0)

        bidx = torch.arange(n, device=dev)[:, None].expand(n, B)
        mm = torch.clamp(in_mask, 0, mask_num - 1)
        px_g = px[bidx, mm, gj, gi]
        py_g = py[bidx, mm, gj, gi]
        pw_g = pw[bidx, mm, gj, gi]
        ph_g = ph[bidx, mm, gj, gi]
        pcls_g = pcls.permute(0, 1, 3, 4, 2)[bidx, mm, gj, gi]  # [N, B, cls]
        um = use.to(dt) * sc
        loss_xy = (_bce(px_g, tx) + _bce(py_g, ty)) * scale * um
        loss_wh = (torch.abs(pw_g - tw) + torch.abs(ph_g - th)) * scale * um
        cls_ids = torch.arange(class_num, device=dev)
        onehot = (glabel.long()[..., None] == cls_ids).to(dt)
        tcls = onehot * smooth_pos + (1 - onehot) * smooth_neg
        loss_cls = torch.sum(_bce(pcls_g, tcls), dim=-1) * um

        # objectness: positives at the assigned cells (the largest weight
        # where two ground truths share one), negatives elsewhere
        flat = ((bidx * mask_num + mm) * h + gj) * w + gi
        obj_pos = torch.zeros(n * mask_num * h * w, dtype=dt, device=dev)
        obj_pos = obj_pos.scatter_reduce(0, flat.reshape(-1), um.reshape(-1),
                                         reduce="amax", include_self=True)
        obj_pos = obj_pos.reshape(n, mask_num, h, w)
        pos_here = obj_pos > 0
        loss_obj = torch.where(pos_here, _bce(pobj, 1.0) * obj_pos,
                               _bce(pobj, 0.0) * noobj_mask)
        return (torch.sum(loss_xy + loss_wh + loss_cls, dim=1)
                + torch.sum(loss_obj, dim=(1, 2, 3)))

    args = [x, gt_box, gt_label] + ([gt_score] if gt_score is not None
                                    else [])
    return _trace(fn, args, "yolo_loss")


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD's prior boxes for every cell of ``input``'s map over
    ``image``.  Returns (boxes [H, W, num_priors, 4], variances of the
    same shape)."""
    min_sizes = ([float(min_sizes)] if np.isscalar(min_sizes)
                 else [float(m) for m in min_sizes])
    max_sizes = ([] if not max_sizes else
                 ([float(max_sizes)] if np.isscalar(max_sizes)
                  else [float(m) for m in max_sizes]))
    in_ars = ([float(aspect_ratios)] if np.isscalar(aspect_ratios)
              else [float(a) for a in aspect_ratios])
    ars = [1.0]
    for ar in in_ars:
        if all(abs(ar - e) > 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    variance = [float(v) for v in variance]

    whs = []
    for s, ms in enumerate(min_sizes):
        if not min_max_aspect_ratios_order:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                m = np.sqrt(ms * max_sizes[s])
                whs.append((m, m))
        else:
            whs.append((ms, ms))
            if max_sizes:
                m = np.sqrt(ms * max_sizes[s])
                whs.append((m, m))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))

    def fn(feat, img):
        dev = feat.device
        f32 = torch.float32
        fh, fw = feat.shape[2], feat.shape[3]
        ih, iw = img.shape[2], img.shape[3]
        step_w = float(steps[0]) or iw / fw
        step_h = float(steps[1]) or ih / fh
        cx = (torch.arange(fw, dtype=f32, device=dev) + offset) * step_w
        cy = (torch.arange(fh, dtype=f32, device=dev) + offset) * step_h
        bw = torch.tensor([v[0] for v in whs], dtype=f32, device=dev) * 0.5
        bh = torch.tensor([v[1] for v in whs], dtype=f32, device=dev) * 0.5
        shape = (fh, fw, len(whs))
        x1 = ((cx[None, :, None] - bw[None, None, :]) / iw).expand(shape)
        y1 = ((cy[:, None, None] - bh[None, None, :]) / ih).expand(shape)
        x2 = ((cx[None, :, None] + bw[None, None, :]) / iw).expand(shape)
        y2 = ((cy[:, None, None] + bh[None, None, :]) / ih).expand(shape)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        if clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        vars_ = torch.tensor(variance, dtype=f32, device=dev).expand(
            boxes.shape).contiguous()
        return boxes, vars_

    return _trace(fn, [input, image], "prior_box")


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Encode corner boxes as center-size deltas against the priors, or
    decode deltas back to corner boxes (the priors along ``axis``)."""
    encode = code_type.lower() in ("encode_center_size", "encode")
    var_is_tensor = not isinstance(prior_box_var, (list, tuple, type(None)))
    var_list = (None if var_is_tensor
                else ([float(v) for v in prior_box_var]
                      if prior_box_var is not None else None))

    def fn(pb, tb, *rest):
        pv = rest[0] if rest else None
        norm = 0.0 if box_normalized else 1.0
        pw = pb[:, 2] - pb[:, 0] + norm
        ph = pb[:, 3] - pb[:, 1] + norm
        pcx = pb[:, 0] + pw * 0.5
        pcy = pb[:, 1] + ph * 0.5
        if var_list is not None:
            v = torch.tensor(var_list, dtype=pb.dtype, device=pb.device)
            v0, v1, v2, v3 = v[0], v[1], v[2], v[3]
        elif pv is not None:
            v0, v1, v2, v3 = pv[:, 0], pv[:, 1], pv[:, 2], pv[:, 3]
        else:
            v0 = v1 = v2 = v3 = torch.ones((), dtype=pb.dtype,
                                           device=pb.device)
        if encode:
            # tb [N, 4] ground truths; out [N, M, 4]
            tw = tb[:, 2] - tb[:, 0] + norm
            th = tb[:, 3] - tb[:, 1] + norm
            tcx = tb[:, 0] + tw * 0.5
            tcy = tb[:, 1] + th * 0.5
            ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / v0
            oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / v1
            ow = torch.log(tw[:, None] / pw[None, :]) / v2
            oh = torch.log(th[:, None] / ph[None, :]) / v3
            return torch.stack([ox, oy, ow, oh], dim=-1)
        # decode: tb [N, M, 4] deltas
        per_prior = var_list is None and pv is not None
        if axis == 0:
            pcx_, pcy_, pw_, ph_ = (pcx[None, :], pcy[None, :],
                                    pw[None, :], ph[None, :])
            vs = ([v[None, :] for v in (v0, v1, v2, v3)] if per_prior
                  else [v0, v1, v2, v3])
        else:
            pcx_, pcy_, pw_, ph_ = (pcx[:, None], pcy[:, None],
                                    pw[:, None], ph[:, None])
            vs = ([v[:, None] for v in (v0, v1, v2, v3)] if per_prior
                  else [v0, v1, v2, v3])
        v0_, v1_, v2_, v3_ = vs
        ocx = v0_ * tb[:, :, 0] * pw_ + pcx_
        ocy = v1_ * tb[:, :, 1] * ph_ + pcy_
        ow = torch.exp(v2_ * tb[:, :, 2]) * pw_
        oh = torch.exp(v3_ * tb[:, :, 3]) * ph_
        return torch.stack([ocx - ow * 0.5, ocy - oh * 0.5,
                            ocx + ow * 0.5 - norm, ocy + oh * 0.5 - norm],
                           dim=-1)

    args = [prior_box, target_box] + ([prior_box_var] if var_is_tensor
                                      else [])
    return _trace(fn, args, "box_coder")


def _iou_corner(a, b, normalized=True):
    norm = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    area_a = (ax2 - ax1 + norm) * (ay2 - ay1 + norm)
    area_b = (bx2 - bx1 + norm) * (by2 - by1 + norm)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
                     + norm, min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
                     + norm, min=0)
    inter = iw * ih
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def _greedy_nms(iou, ok0, threshold, eta=1.0):
    """The reference's greedy NMS over candidates sorted by score, for
    every leading index at once.  ``iou`` [..., k, k], ``ok0`` [..., k]
    (a candidate may be kept at all); candidate i is kept when ``ok0``
    and no earlier kept candidate overlaps it by more than the threshold,
    which ``eta`` < 1 multiplies after each keep while it is above 0.5
    (the threshold is held in the IoUs' dtype).  Returns keep [..., k]."""
    k = ok0.shape[-1]
    keep = torch.zeros_like(ok0)
    th = torch.full(ok0.shape[:-1], threshold, dtype=iou.dtype,
                    device=ok0.device)
    for i in range(k):
        over = (iou[..., i, :i] > th[..., None]) & keep[..., :i]
        kept = ok0[..., i] & ~over.any(dim=-1)
        if eta < 1.0:
            th = torch.where(kept & (th > 0.5), th * eta, th)
        keep[..., i] = kept
    return keep


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_index=False,
                   rois_num=None):
    """Greedy NMS per class, then the ``keep_top_k`` best across classes.

    bboxes [N, M, 4]; scores [N, C, M].  Returns (out [N, keep_top_k, 6]
    padded with -1 rows, nms_num [N]) and, with ``return_index``, the
    candidate index of each row (-1 on the padding).
    """

    def fn(bb, sc):
        n, m, _ = bb.shape
        c = sc.shape[1]
        dev = bb.device
        k = min(int(nms_top_k) if nms_top_k > 0 else m, m)
        keep_k = int(keep_top_k) if keep_top_k > 0 else k * c

        s_top, idx = _top(sc, k)                        # [N, C, k]
        b_top = _gather_rows(bb, idx.reshape(n, c * k)).reshape(n, c, k, 4)
        iou = _iou_corner(b_top[:, :, :, None, :], b_top[:, :, None, :, :],
                          normalized)
        keep = _greedy_nms(iou, s_top > score_threshold, nms_threshold,
                           nms_eta)
        if 0 <= background_label < c:
            keep[:, background_label] = False
        cls_id = torch.arange(c, device=dev)[:, None].expand(c, k)
        neg = torch.full((), -1.0, dtype=s_top.dtype, device=dev)
        flat_s = torch.where(keep, s_top, neg).reshape(n, c * k)
        flat_i = idx.reshape(n, c * k)
        s_sel, order = _top(flat_s, min(keep_k, c * k))
        sel_i = torch.gather(flat_i, 1, order)
        sel_c = cls_id.reshape(-1)[order]
        valid = s_sel > -1.0
        sel_b = _gather_rows(bb, sel_i)                 # [N, keep, 4]
        negb = torch.full((), -1.0, dtype=bb.dtype, device=dev)
        out = torch.cat(
            [torch.where(valid, sel_c.to(bb.dtype), negb)[..., None],
             torch.where(valid, s_sel, neg)[..., None],
             torch.where(valid[..., None], sel_b, negb)], dim=-1)
        index = torch.where(valid, sel_i, -1).to(torch.int32)
        nums = valid.sum(dim=1)
        return out, nums, index

    out, nums, idx = _trace(fn, [bboxes, scores], "multiclass_nms")
    if return_index:
        return out, nums, idx
    return out, nums


def _roi_batch(rest, r, counts, device):
    """The image of each of ``r`` RoIs: from per-image counts
    (``boxes_num``), from explicit indices, or image 0."""
    if not rest:
        return torch.zeros((r,), dtype=torch.long, device=device)
    bn = rest[0].long().reshape(-1)
    if counts:
        ends = torch.cumsum(bn, 0)
        return (torch.arange(r, device=device)[:, None]
                >= ends[None, :]).long().sum(dim=1)
    return bn


def roi_align(x, boxes, boxes_num=None, output_size=(1, 1),
              spatial_scale=1.0, sampling_ratio=-1, aligned=True,
              name=None, batch_indices=None):
    """The average of ``sampling_ratio``² bilinear samples in each output
    bin of each RoI.

    x [N, C, H, W]; boxes [R, 4] (x1, y1, x2, y2); each box's image from
    ``boxes_num`` [N] (per-image counts) or ``batch_indices`` [R].
    ``sampling_ratio=-1`` takes 2 samples a bin side (static shapes, as
    the reference)."""
    ph, pw = ((output_size, output_size) if np.isscalar(output_size)
              else tuple(output_size))
    sr = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    counts = boxes_num is not None

    def fn(xa, bx, *rest):
        n, ch, h, w = xa.shape
        r = bx.shape[0]
        dev, dt = xa.device, xa.dtype
        bidx = _roi_batch(rest, r, counts, dev)
        off = 0.5 if aligned else 0.0
        x1 = bx[:, 0] * spatial_scale - off
        y1 = bx[:, 1] * spatial_scale - off
        x2 = bx[:, 2] * spatial_scale - off
        y2 = bx[:, 3] * spatial_scale - off
        rw = x2 - x1
        rh = y2 - y1
        if not aligned:
            rw = torch.clamp(rw, min=1.0)
            rh = torch.clamp(rh, min=1.0)
        bin_w = rw / pw
        bin_h = rh / ph
        samples = (torch.arange(sr, device=dev, dtype=dt) + 0.5) / sr
        iy = torch.arange(ph, device=dev, dtype=dt)[:, None] + samples[None]
        ix = torch.arange(pw, device=dev, dtype=dt)[:, None] + samples[None]
        yy = (y1[:, None, None] + iy[None] * bin_h[:, None, None]).reshape(
            r, -1)                                   # [R, ph*sr]
        xx = (x1[:, None, None] + ix[None] * bin_w[:, None, None]).reshape(
            r, -1)                                   # [R, pw*sr]
        y0 = torch.floor(yy)
        x0 = torch.floor(xx)
        img = xa.permute(0, 2, 3, 1).reshape(n, h * w, ch)
        out = 0.0
        for oy in (0, 1):
            for ox in (0, 1):
                yc = y0 + oy
                xc = x0 + ox
                vy = (yy >= -1.0) & (yc >= 0) & (yc <= h - 1)
                vx = (xx >= -1.0) & (xc >= 0) & (xc <= w - 1)
                yi = torch.clamp(yc, 0, h - 1).long()
                xi = torch.clamp(xc, 0, w - 1).long()
                wy = (yy - y0 if oy else 1 - (yy - y0)) * vy
                wx = (xx - x0 if ox else 1 - (xx - x0)) * vx
                flat = yi[:, :, None] * w + xi[:, None, :]   # [R, P, Q]
                g = img[bidx[:, None, None], flat]           # [R, P, Q, C]
                out = out + g * (wy[:, :, None] * wx[:, None, :])[..., None]
        out = out.reshape(r, ph, sr, pw, sr, ch).mean(dim=(2, 4))
        return out.permute(0, 3, 1, 2).contiguous()

    extra = ([boxes_num] if boxes_num is not None
             else ([batch_indices] if batch_indices is not None else []))
    return _trace(fn, [x, boxes] + extra, "roi_align")


def roi_pool(x, boxes, boxes_num=None, output_size=(1, 1),
             spatial_scale=1.0, name=None, batch_indices=None):
    """Fast R-CNN's RoI max pooling: corners scaled by ``spatial_scale``
    and rounded to pixels, the RoI at least one pixel a side, each bin
    ``[floor(i * bin), ceil((i + 1) * bin))`` clipped to the map, the max
    over its cells, 0 for an empty bin.  The bins' cells are masks over
    the whole H / W axes, and the max is taken over W, then over H."""
    ph, pw = ((output_size, output_size) if np.isscalar(output_size)
              else tuple(output_size))
    counts = boxes_num is not None

    def fn(xa, bx, *rest):
        n, ch, h, w = xa.shape
        r = bx.shape[0]
        dev = xa.device
        bidx = _roi_batch(rest, r, counts, dev)
        x1 = torch.round(bx[:, 0] * spatial_scale).to(torch.int32)
        y1 = torch.round(bx[:, 1] * spatial_scale).to(torch.int32)
        x2 = torch.round(bx[:, 2] * spatial_scale).to(torch.int32)
        y2 = torch.round(bx[:, 3] * spatial_scale).to(torch.int32)
        roi_h = torch.clamp(y2 - y1 + 1, min=1).to(torch.float32)
        roi_w = torch.clamp(x2 - x1 + 1, min=1).to(torch.float32)
        bin_h = roi_h / ph
        bin_w = roi_w / pw
        ii = torch.arange(ph, dtype=torch.float32, device=dev)
        jj = torch.arange(pw, dtype=torch.float32, device=dev)
        hs = torch.clamp(torch.floor(ii[None] * bin_h[:, None]).to(torch.int32)
                         + y1[:, None], 0, h)
        he = torch.clamp(torch.ceil((ii[None] + 1) * bin_h[:, None])
                         .to(torch.int32) + y1[:, None], 0, h)
        ws = torch.clamp(torch.floor(jj[None] * bin_w[:, None]).to(torch.int32)
                         + x1[:, None], 0, w)
        we = torch.clamp(torch.ceil((jj[None] + 1) * bin_w[:, None])
                         .to(torch.int32) + x1[:, None], 0, w)
        rows = torch.arange(h, device=dev)[None, None, :]
        cols = torch.arange(w, device=dev)[None, None, :]
        mh = (rows >= hs[..., None]) & (rows < he[..., None])   # [R, ph, H]
        mw = (cols >= ws[..., None]) & (cols < we[..., None])   # [R, pw, W]
        ninf = torch.full((), -math.inf, dtype=xa.dtype, device=dev)
        img = xa[bidx]                                           # [R, C, H, W]
        colmax = torch.where(mw[:, None, None], img[:, :, :, None, :],
                             ninf).amax(dim=-1)                  # [R, C, H, pw]
        out = torch.where(mh[:, None, :, :, None], colmax[:, :, None],
                          ninf).amax(dim=3)                      # [R, C, ph, pw]
        return torch.where(torch.isfinite(out), out,
                           torch.zeros((), dtype=xa.dtype, device=dev))

    extra = ([boxes_num] if boxes_num is not None
             else ([batch_indices] if batch_indices is not None else []))
    return _trace(fn, [x, boxes] + extra, "roi_pool")


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    """The RPN's proposals: anchors decoded by the deltas, clipped to the
    image, small ones dropped, the ``pre_nms_top_n`` best through greedy
    NMS, the ``post_nms_top_n`` best of those.  Returns (rois [N,
    post_nms_top_n, 4] with zero rows after the kept ones, their scores)
    and, with ``return_rois_num``, the count per image.

    The deltas' width and height exponents are capped at log(1000 / 16)
    in float64, so the boxes, the IoUs and the outputs are float64, as
    the reference's are under its 64-bit mode."""
    cap = np.log(1000. / 16.)

    def fn(sc, deltas, imgs, anc, var):
        n, a4, h, w = deltas.shape
        a = a4 // 4
        m = a * h * w
        k = min(int(pre_nms_top_n), m)
        kk = min(int(post_nms_top_n), k)
        anc_f = anc.reshape(-1, 4)
        var_f = var.reshape(-1, 4)
        sc_f = torch.movedim(sc.reshape(n, a, h, w), 1, -1).reshape(n, m)
        dl = torch.movedim(deltas.reshape(n, a, 4, h, w), (1, 2), (2, 3))
        dl = dl.reshape(n, m, 4)

        pw = anc_f[:, 2] - anc_f[:, 0] + 1.0
        phh = anc_f[:, 3] - anc_f[:, 1] + 1.0
        pcx = anc_f[:, 0] + pw * 0.5
        pcy = anc_f[:, 1] + phh * 0.5
        ocx = var_f[:, 0] * dl[..., 0] * pw + pcx
        ocy = var_f[:, 1] * dl[..., 1] * phh + pcy
        ow = torch.exp(torch.clamp((var_f[:, 2] * dl[..., 2]).double(),
                                   max=cap)) * pw
        oh = torch.exp(torch.clamp((var_f[:, 3] * dl[..., 3]).double(),
                                   max=cap)) * phh
        im_h = imgs[:, 0].double()[:, None] - 1
        im_w = imgs[:, 1].double()[:, None] - 1
        zero = torch.zeros((), dtype=torch.float64, device=sc.device)

        def clip(v, hi):
            return torch.minimum(torch.maximum(v, zero), hi)

        x1 = clip(ocx - ow * 0.5, im_w)
        y1 = clip(ocy - oh * 0.5, im_h)
        x2 = clip(ocx + ow * 0.5, im_w)
        y2 = clip(ocy + oh * 0.5, im_h)
        keep_sz = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
        s2 = torch.where(keep_sz, sc_f, torch.full((), -1e10, dtype=sc_f.dtype,
                                                   device=sc.device))
        s_top, idx = _top(s2, k)
        boxes = _gather_rows(torch.stack([x1, y1, x2, y2], -1), idx)
        iou = _iou_corner(boxes[:, :, None], boxes[:, None, :],
                          normalized=False)
        keep = _greedy_nms(iou, s_top > -1e9, nms_thresh)
        low = torch.full((), -1e10, dtype=s_top.dtype, device=sc.device)
        s_fin, order = _top(torch.where(keep, s_top, low), kk)
        valid = s_fin > -1e9
        out = _gather_rows(boxes, order) * valid[..., None]
        return out, s_fin * valid, valid.sum(dim=1)

    rois, rscores, num = _trace(
        fn, [scores, bbox_deltas, img_size, anchors, variances],
        "generate_proposals")
    if return_rois_num:
        return rois, rscores, num
    return rois, rscores


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Each RoI's FPN level by its scale (levels, not compacted lists:
    the shapes stay static)."""

    def fn(rois):
        w = rois[:, 2] - rois[:, 0]
        h = rois[:, 3] - rois[:, 1]
        scale = torch.sqrt(torch.clamp(w * h, min=1e-10))
        lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
        return torch.clamp(lvl, min_level, max_level).to(torch.int32)

    return _trace(fn, [fpn_rois], "distribute_fpn_proposals")


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution, v1 (``mask`` None) or v2: each tap samples
    the padded input bilinearly at its position plus the learned offset
    (zero outside), times the tap's mask, and the im2col matrix of those
    samples is contracted with the weights."""
    s = [stride] * 2 if isinstance(stride, int) else list(stride)
    p = [padding] * 2 if isinstance(padding, int) else list(padding)
    d = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    ins = [x, offset, weight] + ([bias] if bias is not None else []) + (
        [mask] if mask is not None else [])
    has_bias = bias is not None
    has_mask = mask is not None

    def fn(xa, off, w, *rest):
        n, cin, h, ww = xa.shape
        cout, cing, kh, kw = w.shape
        dev = xa.device
        oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
        ow = (ww + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
        xa = torch.nn.functional.pad(xa, (p[1], p[1], p[0], p[0]))
        hp, wp = xa.shape[2:]
        dg = deformable_groups
        cpg = cin // dg
        imgf = xa.reshape(n, dg, cpg, hp * wp)
        # offsets: (n, 2*dg*kh*kw, oh, ow), (dy, dx) interleaved per tap
        off = off.reshape(n, dg, kh * kw, 2, oh, ow)

        def sample(yy, xx):
            """Bilinear samples at (yy, xx) (n, dg, oh, ow): (n, dg, cpg,
            oh, ow), zero outside."""
            y0 = torch.floor(yy)
            x0 = torch.floor(xx)
            wy = yy - y0
            wx = xx - x0
            acc = 0.0
            for oy in (0, 1):
                for ox in (0, 1):
                    yc = y0 + oy
                    xc = x0 + ox
                    valid = ((yc >= 0) & (yc <= hp - 1)
                             & (xc >= 0) & (xc <= wp - 1))
                    yi = torch.clamp(yc, 0, hp - 1).long()
                    xi = torch.clamp(xc, 0, wp - 1).long()
                    flat = (yi * wp + xi).reshape(n, dg, 1, oh * ow)
                    flat = flat.expand(n, dg, cpg, oh * ow)
                    g = torch.gather(imgf, 3, flat).reshape(n, dg, cpg, oh,
                                                            ow)
                    wgt = ((wy if oy else 1 - wy) * (wx if ox else 1 - wx)
                           * valid)
                    acc = acc + g * wgt[:, :, None]
            return acc

        base_y = torch.arange(oh, device=dev)[:, None] * s[0]
        base_x = torch.arange(ow, device=dev)[None, :] * s[1]
        cols = []
        for ky in range(kh):
            for kx in range(kw):
                tap = ky * kw + kx
                yy = (base_y + ky * d[0])[None, None].to(torch.float32) \
                    + off[:, :, tap, 0]
                xx = (base_x + kx * d[1])[None, None].to(torch.float32) \
                    + off[:, :, tap, 1]
                g = sample(yy, xx)                 # (n, dg, cpg, oh, ow)
                if has_mask:
                    mk = rest[-1].reshape(n, dg, kh * kw, oh, ow)[:, :, tap]
                    g = g * mk[:, :, None]
                cols.append(g)
        # taps -> the im2col matrix (n, cin * kh * kw, oh, ow), channel
        # major then tap, as w.reshape(cout, cing * kh * kw) reads it
        col = torch.stack(cols, dim=3).reshape(n, cin * kh * kw, oh, ow)
        wmat = w.reshape(cout, cing * kh * kw)
        if groups == 1:
            out = torch.einsum("ok,nkhw->nohw", wmat, col)
        else:
            cols_g = col.reshape(n, groups, (cin // groups) * kh * kw,
                                 oh, ow)
            wg = wmat.reshape(groups, cout // groups, -1)
            out = torch.einsum("gok,ngkhw->ngohw", wg, cols_g).reshape(
                n, cout, oh, ow)
        if has_bias:
            out = out + rest[0].reshape(1, -1, 1, 1)
        return out.to(xa.dtype)

    return _trace(fn, ins, "deform_conv2d")


class DeformConv2D(Layer):
    """The layer form of :func:`deform_conv2d`: weight ``[out, in /
    groups, kh, kw]`` and bias ``[out]`` (none with ``bias_attr=False``);
    ``forward(x, offset, mask=None)``."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 stride=1, padding=0, dilation=1,
                 deformable_groups=1, groups=1, weight_attr=None,
                 bias_attr=None):
        super().__init__("_deformconv2d")
        k = ([kernel_size] * 2 if isinstance(kernel_size, int)
             else list(kernel_size))
        self._attrs = (stride, padding, dilation, deformable_groups, groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups] + k, attr=weight_attr)
        self.bias = (None if bias_attr is False
                     else self.create_parameter(
                         [out_channels], attr=bias_attr, is_bias=True))

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._attrs
        return deform_conv2d(x, offset, self.weight, self.bias,
                             s, p, d, dg, g, mask)
