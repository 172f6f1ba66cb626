"""The port's ``vision.transforms`` against the reference's on the CPU.

Every functional form and every transform class runs on the same seeded
HWC arrays (uint8 and float32) in both packages; the random transforms
draw from Python's ``random`` module in both, seeded alike before each
call.  Float outputs within 1e-5 relative (1e-4 absolute on the 0-255
range: the resize contracts in another order); uint8 outputs at most 1
apart, on at most 2% of the elements of one output, and equal elsewhere:
a resized value within float32 rounding of an integer truncates either
way (measured: 0.017% of 54006 elements over 40 random resizes, 1.04% of
one 12 x 12 x 3 output).  The resize test also checks that each such
element's float value lies within 1e-3 of an integer.  The resize is
checked shrinking, enlarging, at non-integer scales and along one axis,
bilinear and nearest.
"""

import random

import numpy as np
import pytest

import paddle_tpu.vision.transforms as J

import paddle_tpu_torch.vision.transforms as T


def _img(dtype, h=20, w=30, c=3, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w, c) * 255
    return a.astype(dtype)


def _close(want, got):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype == np.uint8:
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 2e-2, (d.max(),
                                                         (d > 0).mean())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _both(make, img, seed=7):
    random.seed(seed)
    want = make(J)(img)
    random.seed(seed)
    got = make(T)(img)
    _close(want, got)
    return got


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("size", [(10, 15), (37, 41), (13, 44), 7, 31,
                                  (20, 17), (9, 30)],
                         ids=["half", "up", "mixed", "short7", "short31",
                              "w_only", "h_only"])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_matches_reference(dtype, size, method):
    img = _img(dtype)
    want, got = J.resize(img, size, method), T.resize(img, size, method)
    _close(want, got)
    flips = np.asarray(want) != got
    if dtype == "uint8" and flips.any():
        f = T.resize(img.astype("float32"), size, method)[flips]
        assert np.abs(f - np.round(f)).max() <= 1e-3, f
    _both(lambda M: M.Resize(size, method), img)


def test_resize_gray_and_wide_images():
    for shape in ((17, 23), (64, 48, 1), (5, 200, 4)):
        img = np.random.RandomState(1).rand(*shape).astype("float32")
        for size in ((11, 13), (90, 7)):
            _close(J.resize(img, size), T.resize(img, size))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_functional_forms_match_reference(dtype):
    img = _img(dtype)
    for name, args in [("to_tensor", ()), ("to_tensor", ("HWC",)),
                       ("hflip", ()), ("vflip", ()),
                       ("crop", (2, 3, 10, 12)), ("center_crop", (11,)),
                       ("center_crop", ((8, 25),)), ("pad", (2,)),
                       ("pad", ((1, 2),)), ("pad", ((1, 2, 3, 4), 7)),
                       ("pad", (3, 0, "reflect")), ("pad", (2, 0, "edge")),
                       ("pad", (2, 0, "symmetric"))]:
        _close(getattr(J, name)(img, *args), getattr(T, name)(img, *args))
    chw = J.to_tensor(img)
    for fmt, x in (("CHW", chw), ("HWC", img)):
        _close(J.normalize(x, [0.5, 0.4, 0.3], [0.2, 0.25, 0.3], fmt),
               T.normalize(x, [0.5, 0.4, 0.3], [0.2, 0.25, 0.3], fmt))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_transform_classes_match_reference(dtype):
    img = _img(dtype, h=24, w=32)
    classes = [
        lambda M: M.ToTensor(), lambda M: M.ToTensor("HWC"),
        lambda M: M.Normalize(0.5, 0.25, "HWC"),
        lambda M: M.CenterCrop(16), lambda M: M.Transpose(),
        lambda M: M.Transpose((1, 0, 2)),
        lambda M: M.Pad(3), lambda M: M.Pad((1, 2), 9, "constant"),
        lambda M: M.Grayscale(), lambda M: M.Grayscale(3),
        lambda M: M.HueTransform(0.3),
        lambda M: M.Compose([M.CenterCrop(20), M.Resize(12),
                             M.Normalize([0.5] * 3, [0.5] * 3, "HWC"),
                             M.Transpose()]),
    ]
    for make in classes:
        _both(make, img)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_transforms_draw_like_the_reference(dtype):
    """Same seeds, same draws: 20 seeds per random transform."""
    img = _img(dtype, h=24, w=32)
    randoms = [
        lambda M: M.RandomCrop(16), lambda M: M.RandomCrop((10, 20), 2),
        lambda M: M.RandomResizedCrop(12),
        lambda M: M.RandomResizedCrop((10, 14), scale=(0.5, 1.0)),
        lambda M: M.RandomHorizontalFlip(), lambda M: M.RandomVerticalFlip(),
        lambda M: M.RandomRotation(30),
        lambda M: M.BrightnessTransform(0.4),
        lambda M: M.ContrastTransform(0.4),
        lambda M: M.SaturationTransform(0.4),
        lambda M: M.ColorJitter(0.3, 0.3, 0.3, 0.1),
        lambda M: M.BrightnessTransform(0),
    ]
    for make in randoms:
        outs = {np.asarray(_both(make, img, seed)).tobytes()
                for seed in range(20)}
        assert len(outs) >= 1


def test_random_resized_crop_falls_back_to_the_center():
    """A ratio no crop can meet: after its 10 draws the transform takes
    the center crop, as the reference's does."""
    img = _img("uint8", h=10, w=40)
    _both(lambda M: M.RandomResizedCrop(8, scale=(0.99, 1.0),
                                        ratio=(0.1, 0.11)), img, seed=3)


def test_surface_matches_reference():
    assert sorted(T.__all__) == sorted(J.__all__)
    for name in J.__all__:
        assert callable(getattr(T, name))
