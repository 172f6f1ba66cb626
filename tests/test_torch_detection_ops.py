"""The port's detection ops (``paddle_tpu_torch.vision.ops``) against the
reference's ``paddle_tpu.vision.ops`` on the CPU.

The twelve cases of ``tests/test_detection_ops.py`` run both packages on
the same seeded inputs and compare every output: float outputs within
1e-5 relative (1e-6 absolute; fp32 sums in another order), counts,
indices, classes and padding rows exactly.  ``yolo_loss`` and
``deform_conv2d`` compare their gradients too, the reference's being
``jax.vjp`` of its function (its tape replays it), at 1e-5 relative of
the gradient's largest element.  Besides: ``roi_pool``,
``distribute_fpn_proposals``, the ``DeformConv2D`` layer, NMS at seeded
random boxes (greedy, eta, ``return_index``, ``keep_top_k`` < 0), the
output dtypes, and the one-off op each records in a static program.
"""

import re

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as tp
from paddle_tpu_torch.vision import ops as tops

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _both(call, *arrays, grad=()):
    """``call(P, ops, *tensors)`` in both packages; the outputs (a list)
    as numpy, and the gradients of the outputs' sum with respect to the
    inputs at the positions in ``grad``."""
    res = []
    for P, ops in ((jp, jops), (tp, tops)):
        ts = [P.to_tensor(a, stop_gradient=i not in grad)
              for i, a in enumerate(arrays)]
        out = call(P, ops, *ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        grads = []
        if grad:
            P.sum(outs[0]).backward()
            grads = [np.asarray(ts[i].grad.numpy()) for i in grad]
        res.append(([np.asarray(o.numpy()) for o in outs], grads))
    return res


def _same(a, b, exact=False):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, **TOL)


def _grads_close(want, got):
    for w, g in zip(want, got):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(w - g).max()) <= 1e-5 * scale, (
            float(np.abs(w - g).max()), scale)


def test_prior_box_matches_reference():
    feat = np.zeros((1, 8, 2, 3), "float32")
    img = np.zeros((1, 3, 10, 12), "float32")
    for kw in (dict(min_sizes=[4.0], max_sizes=[8.0], aspect_ratios=[2.0],
                    flip=True, clip=True),
               dict(min_sizes=[3.0, 5.0], max_sizes=[6.0, 9.0],
                    aspect_ratios=[2.0, 3.0], flip=False, offset=0.3,
                    min_max_aspect_ratios_order=True, steps=[4.0, 5.0])):
        (want, _), (got, _) = _both(
            lambda P, ops, f, i: ops.prior_box(
                f, i, variance=[0.1, 0.1, 0.2, 0.2], **kw), feat, img)
        for a, b in zip(want, got):
            _same(a, b)


def test_box_coder_decode_encode_matches_reference():
    priors = np.array([[0.1, 0.1, 0.5, 0.5], [0.2, 0.3, 0.7, 0.9]], "float32")
    gt = np.array([[0.15, 0.2, 0.6, 0.7], [0.0, 0.1, 0.3, 0.2]], "float32")
    var = [0.1, 0.1, 0.2, 0.2]
    (enc_w, _), (enc_g, _) = _both(
        lambda P, ops, p, g: ops.box_coder(p, var, g), priors, gt)
    _same(enc_w[0], enc_g[0])
    pvar = np.tile(np.array(var, "float32"), (2, 1))
    for axis in (0, 1):
        for normalized in (True, False):
            (dec_w, _), (dec_g, _) = _both(
                lambda P, ops, p, d, v: ops.box_coder(
                    p, v, d, code_type="decode_center_size", axis=axis,
                    box_normalized=normalized), priors, enc_w[0], pvar)
            _same(dec_w[0], dec_g[0])
        (dec_w, _), (dec_g, _) = _both(
            lambda P, ops, p, d: ops.box_coder(
                p, None, d, code_type="decode", axis=axis), priors, enc_w[0])
        _same(dec_w[0], dec_g[0])


@pytest.mark.parametrize("clip,thresh,scale", [(False, 0.0, 1.0),
                                               (True, 0.3, 1.05)])
def test_yolo_box_matches_reference(clip, thresh, scale):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 2 * 8, 3, 4).astype("float32")
    img = np.array([[64, 80], [50, 40]], "int32")
    (want, _), (got, _) = _both(
        lambda P, ops, a, i: ops.yolo_box(
            a, i, [10, 13, 16, 30], 3, conf_thresh=thresh,
            downsample_ratio=32, clip_bbox=clip, scale_x_y=scale), x, img)
    for a, b in zip(want, got):
        _same(a, b)


def test_yolo_box_conf_threshold_zeroes():
    x = np.full((1, 8, 2, 2), -5.0, "float32")
    img = np.array([[64, 64]], "int32")
    (want, _), (got, _) = _both(
        lambda P, ops, a, i: ops.yolo_box(a, i, [10, 13], 3, conf_thresh=0.5,
                                          downsample_ratio=32), x, img)
    for a, b in zip(want, got):
        _same(a, b, exact=True)
        assert not b.any()


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss_and_its_gradient_match_reference(smooth, score):
    an = [10, 13, 16, 30, 33, 23]
    cls = 4
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3 * (5 + cls), 4, 4).astype("float32") * 0.5
    gt = np.zeros((2, 3, 4), "float32")
    gt[0, 0] = [0.5, 0.5, 0.2, 0.3]
    gt[0, 1] = [0.2, 0.7, 0.6, 0.4]
    gt[1, 0] = [0.81, 0.33, 0.05, 0.1]
    lbl = np.array([[1, 3, 0], [2, 0, 0]], "int64")
    gs = rng.rand(2, 3).astype("float32")
    arrays = [x, gt, lbl] + ([gs] if score else [])
    (want, gw), (got, gg) = _both(
        lambda P, ops, a, g, l, *s: ops.yolo_loss(
            a, g, l, an, [0, 1, 2], cls, ignore_thresh=0.5,
            downsample_ratio=8, gt_score=s[0] if s else None,
            use_label_smooth=smooth),
        *arrays, grad=(0,))
    _same(want[0], got[0])
    assert (got[0] > 0).all()
    _grads_close(gw, gg)
    # the other heads' masks: a box whose best anchor is outside the mask
    (want, gw), (got, gg) = _both(
        lambda P, ops, a, g, l: ops.yolo_loss(
            a, g, l, an, [1, 2, 0], cls, ignore_thresh=0.7,
            downsample_ratio=16), x, gt, lbl, grad=(0,))
    _same(want[0], got[0])
    _grads_close(gw, gg)


def _np_nms(boxes, scores, thr):
    order = np.argsort(-scores, kind="stable")
    keep = []
    for i in order:
        ok = True
        for j in keep:
            x1 = max(boxes[i, 0], boxes[j, 0])
            y1 = max(boxes[i, 1], boxes[j, 1])
            x2 = min(boxes[i, 2], boxes[j, 2])
            y2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(x2 - x1, 0) * max(y2 - y1, 0)
            a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            a2 = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            if inter / (a1 + a2 - inter) > thr:
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


def _nms_both(boxes, scores, **kw):
    (want, _), (got, _) = _both(
        lambda P, ops, b, s: ops.multiclass_nms(b, s, return_index=True,
                                                **kw), boxes, scores)
    _same(want[0], got[0])
    _same(want[1], got[1], exact=True)
    _same(want[2], got[2], exact=True)
    return got


def test_multiclass_nms_matches_reference_and_numpy():
    boxes = np.array([[0.0, 0.0, 0.4, 0.4], [0.05, 0.05, 0.45, 0.45],
                      [0.6, 0.6, 0.9, 0.9], [0.0, 0.5, 0.3, 0.9]],
                     "float32")[None]
    scores = np.zeros((1, 2, 4), "float32")
    scores[0, 1] = [0.9, 0.8, 0.7, 0.05]
    out, nums, idx = _nms_both(boxes, scores, score_threshold=0.1,
                               nms_top_k=4, keep_top_k=4, nms_threshold=0.5,
                               background_label=0)
    keep = [k for k in _np_nms(boxes[0], scores[0, 1], 0.5)
            if scores[0, 1, k] > 0.1]
    assert int(nums[0]) == len(keep) == 2
    np.testing.assert_allclose(out[0, 0], [1, 0.9, 0, 0, 0.4, 0.4], **TOL)
    np.testing.assert_allclose(out[0, 1], [1, 0.7, 0.6, 0.6, 0.9, 0.9], **TOL)
    assert np.all(out[0, 2:] == -1) and list(idx[0]) == [0, 2, -1, -1]


@pytest.mark.parametrize("eta,keep_top_k,bg", [(1.0, -1, 0), (0.7, -1, -1),
                                                (1.0, 5, 2)])
def test_multiclass_nms_random_boxes(eta, keep_top_k, bg):
    """Seeded boxes and scores over 2 images and 4 classes, one score tie
    (the lower index first): each class's kept set is numpy's greedy NMS
    (eta 1), and every output equals the reference's."""
    rng = np.random.RandomState(5)
    xy = rng.rand(2, 24, 2).astype("float32") * 0.8
    wh = rng.rand(2, 24, 2).astype("float32") * 0.3 + 0.05
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(2, 4, 24).astype("float32")
    scores[0, 1, 7] = scores[0, 1, 3]
    out, nums, idx = _nms_both(boxes, scores, score_threshold=0.2,
                               nms_top_k=16, keep_top_k=keep_top_k,
                               nms_threshold=0.4, nms_eta=eta,
                               background_label=bg)
    if eta == 1.0 and keep_top_k < 0:
        for b in range(2):
            for c in range(4):
                if c == bg:
                    continue
                s = scores[b, c]
                top = np.argsort(-s, kind="stable")[:16]
                kept = [int(top[i]) for i in _np_nms(
                    boxes[b][top], s[top], 0.4) if s[top[i]] > 0.2]
                rows = out[b][(out[b, :, 0] == c)]
                got = [int(i) for i, o in zip(idx[b], out[b])
                       if o[0] == c]
                assert sorted(got) == sorted(kept), (b, c)
                assert len(rows) == len(kept)


def _ramp():
    return np.arange(16, dtype="float32").reshape(1, 1, 4, 4)


def test_roi_align_single_pixel_bins():
    rois = np.array([[0.5, 0.5, 2.5, 2.5], [0.2, 0.9, 3.7, 2.1]], "float32")
    (want, _), (got, _) = _both(
        lambda P, ops, a, r, n: ops.roi_align(
            a, r, boxes_num=n, output_size=(2, 2), spatial_scale=1.0,
            sampling_ratio=1, aligned=True),
        _ramp(), rois, np.array([2], "int32"))
    _same(want[0], got[0])


def test_roi_align_batch_routing():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 6, 5).astype("float32")
    rois = np.array([[0, 0, 2, 2], [1, 0.5, 4, 5], [-0.5, 2, 3, 3.5]],
                    "float32")
    for sr, aligned in ((2, False), (-1, True), (3, True)):
        (want, _), (got, _) = _both(
            lambda P, ops, a, r, n: ops.roi_align(
                a, r, boxes_num=n, output_size=(3, 2), spatial_scale=0.8,
                sampling_ratio=sr, aligned=aligned),
            x, rois, np.array([1, 2], "int32"))
        _same(want[0], got[0])


def test_roi_align_explicit_batch_indices():
    x = np.stack([np.zeros((1, 4, 4), "float32"),
                  np.ones((1, 4, 4), "float32")])
    rois = np.array([[0, 0, 2, 2], [0, 0, 2, 2]], "float32")
    (want, _), (got, _) = _both(
        lambda P, ops, a, r, i: ops.roi_align(
            a, r, batch_indices=i, output_size=1, spatial_scale=1.0,
            sampling_ratio=2, aligned=False),
        x, rois, np.array([0, 1], "int32"))
    _same(want[0], got[0])
    assert abs(got[0][0, 0, 0, 0]) < 1e-6 and abs(got[0][1, 0, 0, 0] - 1) < 1e-6


def test_roi_pool_matches_reference():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 7, 9).astype("float32")
    rois = np.array([[0, 0, 4, 3], [2.4, 1.2, 8.6, 6.4], [5, 5, 5, 5],
                     [-3, -2, 1, 1]], "float32")
    for out_size, scale in (((2, 3), 1.0), (3, 0.5)):
        (want, _), (got, _) = _both(
            lambda P, ops, a, r, n: ops.roi_pool(
                a, r, boxes_num=n, output_size=out_size,
                spatial_scale=scale), x, rois, np.array([3, 1], "int32"))
        _same(want[0], got[0], exact=True)


def test_generate_proposals_matches_reference():
    rng = np.random.RandomState(3)
    h = w = 4
    a = 3
    scores = rng.rand(2, a, h, w).astype("float32")
    deltas = (rng.randn(2, a * 4, h, w) * 0.3).astype("float32")
    anchors = rng.rand(h, w, a, 4).astype("float32") * 8
    anchors[..., 2:] += 8
    variances = np.full((h, w, a, 4), 0.1, "float32")
    img = np.array([[32.0, 32.0], [24.0, 28.0]], "float32")
    (want, _), (got, _) = _both(
        lambda P, ops, s, d, i, an, v: ops.generate_proposals(
            s, d, i, an, v, pre_nms_top_n=20, post_nms_top_n=5,
            nms_thresh=0.6, min_size=1.0, return_rois_num=True),
        scores, deltas, img, anchors, variances)
    _same(want[0], got[0])
    _same(want[1], got[1])
    _same(want[2], got[2], exact=True)
    n = int(got[2][0])
    assert 1 <= n <= 5 and (got[0][0, :n] >= 0).all()


def test_distribute_fpn_proposals_matches_reference():
    rng = np.random.RandomState(7)
    rois = rng.rand(12, 4).astype("float32") * 300
    rois[:, 2:] += rois[:, :2]
    (want, _), (got, _) = _both(
        lambda P, ops, r: ops.distribute_fpn_proposals(r, 2, 5, 4, 224),
        rois)
    _same(want[0], got[0], exact=True)


@pytest.mark.parametrize("case", ["v1", "v2_groups"])
def test_deform_conv2d_and_its_gradients_match_reference(case):
    rng = np.random.RandomState(8)
    n, cin, h, w, cout, k = 2, 4, 6, 5, 6, 3
    dg, groups = (1, 1) if case == "v1" else (2, 2)
    stride, pad, dil = (1, 1, 1) if case == "v1" else (2, 2, 2)
    oh = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    x = rng.randn(n, cin, h, w).astype("float32")
    off = (rng.randn(n, 2 * dg * k * k, oh, ow) * 1.3).astype("float32")
    wt = rng.randn(cout, cin // groups, k, k).astype("float32") * 0.3
    b = rng.randn(cout).astype("float32")
    arrays = [x, off, wt, b]
    if case != "v1":
        arrays.append(rng.rand(n, dg * k * k, oh, ow).astype("float32"))
    (want, gw), (got, gg) = _both(
        lambda P, ops, a, o, wt_, b_, *m: ops.deform_conv2d(
            a, o, wt_, b_, stride=stride, padding=pad, dilation=dil,
            deformable_groups=dg, groups=groups, mask=m[0] if m else None),
        *arrays, grad=tuple(range(len(arrays))))
    _same(want[0], got[0])
    _grads_close(gw, gg)


def test_deform_conv2d_layer_and_static_forms():
    """``DeformConv2D`` on carried weights equals the reference layer, and
    ``static.nn.deform_conv2d`` / ``fluid.layers.deformable_conv`` record
    the one-off op of ``vision.ops.deform_conv2d``."""
    from paddle_tpu.framework import unique_name as jnames
    from paddle_tpu_torch.framework import unique_name as tnames

    rng = np.random.RandomState(9)
    x = rng.randn(1, 3, 5, 5).astype("float32")
    off = rng.randn(1, 18, 5, 5).astype("float32")
    mask = rng.rand(1, 9, 5, 5).astype("float32")
    outs = []
    for P, names in ((jp, jnames), (tp, tnames)):
        with names.guard():
            P.seed(0)
            layer = P.vision.ops.DeformConv2D(3, 4, 3, padding=1)
        if P is tp:
            layer.weight.set_value(want_w)
            layer.bias.set_value(want_b)
        else:
            want_w, want_b = layer.weight.numpy(), layer.bias.numpy()
        outs.append(layer(P.to_tensor(x), P.to_tensor(off),
                          P.to_tensor(mask)).numpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    types = []
    for P in (jp, tp):
        main, startup = P.static.Program(), P.static.Program()
        P.enable_static()
        try:
            with P.static.program_guard(main, startup):
                xv = P.static.data("x", [1, 3, 5, 5], "float32")
                ov = P.static.data("o", [1, 18, 5, 5], "float32")
                mv = P.static.data("m", [1, 9, 5, 5], "float32")
                P.static.nn.deform_conv2d(xv, ov, mv, 4, 3, padding=1)
                P.fluid.layers.deformable_conv(xv, ov, mv, 4, 3, padding=1)
        finally:
            P.disable_static()
        types.append([re.sub(r"_\d+$", "", o.type)
                      for o in main.global_block().ops])
    assert types[0] == types[1] == ["__pyfunc_deform_conv2d"] * 2


def test_vision_ops_surface():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in jops.__all__:
        assert callable(getattr(tops, name))
    import paddle_tpu_torch.static.nn as snn

    for name in ("conv2d", "batch_norm", "layer_norm", "embedding",
                 "sequence_pool", "multi_box_head", "deform_conv2d"):
        assert hasattr(snn, name)


def _static_types(P, ops, build):
    main, startup = P.static.Program(), P.static.Program()
    P.enable_static()
    try:
        with P.static.program_guard(main, startup):
            build(P, ops)
    finally:
        P.disable_static()
    return [re.sub(r"_\d+$", "", o.type) for o in main.global_block().ops]


def _build_all(P, ops):
    d = P.static.data
    feat, img = d("f", [1, 8, 2, 3], "float32"), d("i", [1, 3, 8, 8], "float32")
    ops.prior_box(feat, img, [2.0])
    pri = d("p", [3, 4], "float32")
    ops.box_coder(pri, [0.1, 0.1, 0.2, 0.2], d("t", [2, 4], "float32"))
    ops.yolo_box(d("y", [1, 16, 2, 2], "float32"), d("s", [1, 2], "int32"),
                 [10, 13, 16, 30], 3, 0.1, 32)
    ops.yolo_loss(d("yl", [1, 24, 2, 2], "float32"),
                  d("g", [1, 2, 4], "float32"), d("l", [1, 2], "int64"),
                  [10, 13, 16, 30], [0, 1], 7, 0.7, 32)
    ops.multiclass_nms(d("b", [1, 5, 4], "float32"),
                       d("sc", [1, 3, 5], "float32"), 0.1, 5, 4)
    x = d("x", [1, 2, 6, 6], "float32")
    r = d("r", [2, 4], "float32")
    ops.roi_align(x, r, output_size=2)
    ops.roi_pool(x, r, output_size=2)
    ops.distribute_fpn_proposals(r, 2, 5, 4, 224)
    ops.generate_proposals(
        d("gs", [1, 2, 2, 2], "float32"), d("gd", [1, 8, 2, 2], "float32"),
        d("gi", [1, 2], "float32"), d("ga", [2, 2, 2, 4], "float32"),
        d("gv", [2, 2, 2, 4], "float32"), pre_nms_top_n=4,
        post_nms_top_n=2)


def test_static_programs_record_the_reference_op_types():
    want = _static_types(jp, jops, _build_all)
    got = _static_types(tp, tops, _build_all)
    assert got == want
    assert len(got) == 9 and all(t.startswith("__pyfunc_") for t in got)


def test_fluid_layers_bind_the_detection_names():
    """``fluid.layers``' detection names call ``vision.ops`` (as the
    reference's do); ``bipartite_match`` raises, as the reference's
    import of its missing op module does."""
    L = tp.fluid.layers
    feat = tp.to_tensor(np.zeros((1, 8, 2, 3), "float32"))
    img = tp.to_tensor(np.zeros((1, 3, 10, 12), "float32"))
    boxes, _ = L.prior_box(feat, img, min_sizes=[4.0])
    want, _ = jp.fluid.layers.prior_box(
        jp.to_tensor(np.zeros((1, 8, 2, 3), "float32")),
        jp.to_tensor(np.zeros((1, 3, 10, 12), "float32")), min_sizes=[4.0])
    np.testing.assert_allclose(boxes.numpy(), want.numpy(), **TOL)
    for name in ("box_coder", "distribute_fpn_proposals", "roi_align",
                 "yolo_box", "yolov3_loss", "multiclass_nms", "roi_pool",
                 "generate_proposals"):
        assert callable(getattr(L, name))
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 5, 5).astype("float32")
    rois = np.array([[0, 0, 3, 3]], "float32")
    got = L.roi_pool(tp.to_tensor(x), tp.to_tensor(rois), 2, 2).numpy()
    want = jp.fluid.layers.roi_pool(jp.to_tensor(x), jp.to_tensor(rois), 2,
                                    2).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="bipartite_match"):
        L.bipartite_match(tp.to_tensor(np.zeros((2, 2), "float32")))
