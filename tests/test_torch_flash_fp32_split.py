"""The arithmetic of the fp32 flash kernels, emulated on the CPU.

``csrc/flash_fwd.cu``'s fp32 forward and ``csrc/flash_bwd.cu``'s fp32 dQ
and dK/dV kernels run every product on the tensor cores in "3xTF32":
each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna``: 10 stored mantissa bits, ties away from zero), and each
8-deep step of a product adds lo.hi + hi.lo and then hi.hi into a
partial that an fp32 add takes into the accumulator.  The forward runs
the online softmax tile by tile in base 2 (``exp2`` of scores scaled by
``scale * log2 e``), with O rescaled and P.V added step by step.  In the
backward ds = p * (dp - delta) * scale is formed as p * ((dp - hi) - lo)
* scale from delta summed in fp64 and handed over as fp32 hi + lo, and
for a pair that holds at least 1/16 of its query's probability with dp
summed in fp64 from the fp32 rows (where a query's probability sits on
few keys, dp - delta cancels).  This file emulates that arithmetic with
PyTorch (bit masks for the rounding, fp32 sums) in the kernels'
summation order (each 8-deep step's three products summed into a fresh
partial, then added to the accumulator; the forward's key tiles and
per-lane sums; the GQA group and the query tiles in one accumulator for
dK/dV) and holds it to ``flash_fwd_plain`` and ``flash_bwd_plain``
within the card tests' fp32 FLASH_TOL, so that the designs' accuracy is
known before the card runs them.  One TF32 product alone misses that
bound, forward and backward, and so does the backward's split without
the fp64 pairs where a query's probability sits on one key.

The CPU rounds every sum to nearest; the tensor cores' own rounding
inside a step is not to nearest and is not emulated here, so a pass
here does not stand in for the card's test of the kernels
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash as tflash

# (rtol, atol): |got - want| <= atol * rms of want's row (at least 1e-2 of
# the tensor's) + rtol * |want|, tests/test_torch_cuda.py's fp32 FLASH_TOL
TOL = (1e-5, 1e-5)
LSE_TOL = (1e-6, 1e-6)   # lse's (the forward's second output)

# layout, B, H, Hkv, S, D, causal, window, scale (None: 1/sqrt(D)):
# shapes of test_torch_cuda.py's FLASH_CASES (D=256 causal and windowed,
# a GQA group of 3, a sequence that is not a multiple of 8 keys),
# BERT-base's attention (bnsd, not causal, D=64) at one batch and two
# heads, and a peaked softmax (scale 0.3 at D=64, 2.4 / sqrt(D): many
# queries put nearly all their probability on one key)
CASES = [
    ("bnsd", 2, 3, 3, 136, 64, True, None, None),
    ("bsnd", 2, 4, 2, 200, 128, True, 48, None),
    ("sbnd", 1, 4, 2, 40, 24, False, None, None),
    ("bsnd", 1, 2, 1, 200, 256, True, None, None),
    ("bsnd", 1, 3, 1, 300, 256, True, 40, None),
    ("bnsd", 1, 2, 2, 512, 64, False, None, None),
    ("bnsd", 1, 2, 2, 136, 64, True, None, 0.3),
]
IDS = [f"{c[0]}-h{c[2]}/{c[3]}-s{c[4]}-d{c[5]}"
       f"{'-causal' if c[6] else ''}{'-w' + str(c[7]) if c[7] else ''}"
       f"{'-peaked' if c[8] else ''}" for c in CASES]
PEAKED = CASES[-1]


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation is thousands of small matmuls: on one thread each
    they do not oversubscribe the cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """``cvt.rna.tf32.f32``: x to 10 stored mantissa bits, to nearest with
    ties away from zero (the bit pattern of the magnitude plus half the
    dropped unit, then masked)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, split=True, acc=None, b3=False):
    """``acc + a @ b`` (``acc`` 0 when not given) over the last axis of
    ``a``, 8 at a time as m16n8k8 does: each step's lo.hi + hi.lo, then
    hi.hi, summed into a fresh partial that an fp32 add takes into the
    accumulator (``split``, as the kernels' ``mma_3xtf32``), or the single
    TF32 product hi.hi chained into it.  ``b3``: b in three TF32 parts,
    lo.hi + hi.lo + hi.mid, then hi.hi (``mma_4xtf32``)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    if b3:
        bm = bl
        bl = _tf32(b - bh - bm)
    if acc is None:
        acc = torch.zeros(*torch.broadcast_shapes(a.shape[:-2],
                                                  b.shape[:-2]),
                          a.shape[-2], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        if not split:
            acc = acc + ah[..., k] @ bh[..., k, :]
            continue
        part = al[..., k] @ bh[..., k, :]
        part = part + ah[..., k] @ bl[..., k, :]
        if b3:
            part = part + ah[..., k] @ bm[..., k, :]
        acc = acc + (part + ah[..., k] @ bh[..., k, :])
    return acc


def _kernel_bwd(q, k, v, out, lse, do, causal, scale, window, layout,
                split=True, heavy=True):
    """dQ, dK, dV as the fp32 kernels compute them (``heavy``: dp in fp64
    where p >= 1/16)."""
    qg, kh, vh = tflash._grouped(q, k, v, layout)
    b, hkv, g, s, d = qg.shape
    dog = tflash._heads(do, layout).reshape(qg.shape)
    delta = tflash.flash_delta(out, do, layout).reshape(b, hkv, g, s, 1, 2)
    hi, lo = delta[..., 0], delta[..., 1]
    lse = lse.reshape(b, hkv, g, s, 1)
    kt, vt = (x.transpose(-1, -2)[:, :, None] for x in (kh, vh))
    p = torch.exp(_mm(qg, kt, split) * scale - lse)
    keep = tflash._visible(s, causal, window, q.device)
    p = torch.where(keep, p, 0.0)
    diff = (_mm(dog, vt, split) - hi) - lo
    if heavy:
        dp64 = torch.einsum("bngqd,bnkd->bngqk", dog.double(), vh.double())
        exact = (dp64 - hi.double() - lo.double()).float()
        diff = torch.where(p >= 1 / 16, exact, diff)
    ds = p * diff * scale
    dq = _mm(ds, kh[:, :, None], split).reshape(b, hkv * g, s, d)

    def group(x):                       # (B, Hkv, S, G * S): head, then query
        return x.permute(0, 1, 4, 2, 3).reshape(b, hkv, s, g * s)

    dv = _mm(group(p), dog.reshape(b, hkv, g * s, d), split)
    dk = _mm(group(ds), qg.reshape(b, hkv, g * s, d), split)
    return (tflash._from_heads(dq, layout, q.shape),
            tflash._from_heads(dk, layout, k.shape),
            tflash._from_heads(dv, layout, v.shape))


# K/V rows a tile of the fp32 forward by head dim, as the dispatch picks
# them (csrc/flash_fwd.cu, fwd_fp32)
FWD_BK = {24: 32, 64: 32, 128: 16, 256: 16}
LOG2E = np.float32(1.4426950408889634)   # the kernels' kLog2e
LN2 = np.float32(0.6931471805599453)     # kLn2


def _kernel_fwd(q, k, v, causal, scale, window, layout, split=True,
                v3=True):
    """out and lse as the fp32 forward kernel computes them: per key tile
    of the dispatch's BK, S = Q.K^T by ``_mm``, scaled to base 2 (``scale
    * log2 e`` in fp32) and -1e30 where masked; the running max m and
    each lane's sum of its two columns of every n8 tile (lane t: keys 2t,
    2t + 1), ``exp2``; O scaled by alpha, then P.V added step by step by
    ``_mm`` with V in three TF32 parts (``v3``; two where not); at the end
    the four lanes' sums added as the two shuffles add them, ``out = O /
    max(l, 1e-30)``, ``lse = m ln 2 + log l``."""
    qg, kh, vh = tflash._grouped(q, k, v, layout)
    b, hkv, g, s, d = qg.shape
    bk = FWD_BK[d]
    scale2 = np.float32(scale) * LOG2E
    keep = tflash._visible(s, causal, window, q.device)
    kt = kh.transpose(-1, -2)[:, :, None]
    m = torch.full((b, hkv, g, s), -1e30)
    lanes = torch.zeros(b, hkv, g, s, 4)
    o = torch.zeros(b, hkv, g, s, d)
    for k0 in range(0, s, bk):
        cols = slice(k0, min(k0 + bk, s))
        st = _mm(qg, kt[..., cols], split)
        st = torch.where(keep[:, cols], st * scale2, -1e30)
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        pad = torch.zeros(b, hkv, g, s, bk)
        pad[..., :p.shape[-1]] = p
        pad = pad.reshape(b, hkv, g, s, bk // 8, 4, 2)
        total = torch.zeros(b, hkv, g, s, 4)
        for n in range(bk // 8):
            total = total + pad[..., n, :, 0]
            total = total + pad[..., n, :, 1]
        lanes = lanes * alpha[..., None] + total
        m = m_new
        o = _mm(p, vh[:, :, None, cols], split, acc=o * alpha[..., None],
                b3=v3 and split)
    l = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))
    l = l.clamp_min(1e-30)
    out = (o / l[..., None]).reshape(b, hkv * g, s, d)
    lse = (m * LN2 + torch.log(l)).reshape(b * hkv * g, s)
    return tflash._from_heads(out, layout, q.shape), lse


def _inputs(case, seed):
    layout, b, h, hkv, s, d, causal, window, scale = case
    rng = np.random.RandomState(seed)

    def make(n):
        shape = {"bnsd": (b, n, s, d), "bsnd": (b, s, n, d),
                 "sbnd": (s, b, n, d)}[layout]
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    q, k, v, do = make(h), make(hkv), make(hkv), make(h)
    scale = scale or 1.0 / np.sqrt(d)
    out, lse = tflash.flash_fwd_plain(q, k, v, causal, scale, window, layout)
    return (q, k, v, out, lse, do, causal, scale, window, layout)


def _used(got, want, tol=TOL):
    """The worst share of the FLASH_TOL bound that ``got`` uses."""
    rtol, atol = tol
    row = want.square().mean(-1, keepdim=True).sqrt()
    row = row.clamp_min(1e-2 * want.square().mean().sqrt())
    return ((got - want).abs() / (atol * row + rtol * want.abs())).max().item()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_tf32_backward_holds_plain_within_flash_tol(case):
    """The 3xTF32 arithmetic within FLASH_TOL fp32 of flash_bwd_plain for
    dQ, dK and dV; a causal first query sees one key, so its dQ is 0 up to
    fp64 rounding on both sides (dp in fp64 where p = 1)."""
    args = _inputs(case, seed=sum(case[1:6]))
    got = _kernel_bwd(*args)
    want = tflash.flash_bwd_plain(*args)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.float32
        used = _used(x, y)
        assert used <= 1.0, f"{name}: {used:.3f} of the bound"
    layout, causal = case[0], case[6]
    if causal:
        for x in (got[0], want[0]):
            assert tflash._heads(x, layout)[:, :, 0].abs().max() <= 1e-12


@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=[IDS[0], IDS[5]])
def test_single_tf32_product_misses_flash_tol(case):
    """One TF32 product (11 bits an operand) is no substitute: dQ misses the
    bound by far, so the bound tells the two designs apart."""
    args = _inputs(case, seed=sum(case[1:6]))
    got = _kernel_bwd(*args, split=False)
    want = tflash.flash_bwd_plain(*args)
    assert _used(got[0], want[0]) > 10.0


def test_fp32_dp_misses_flash_tol_where_one_key_holds_the_row():
    """Without the fp64 dp of the heavy pairs, a peaked softmax's dQ
    misses the bound: dp - delta cancels on the key that holds the row."""
    args = _inputs(PEAKED, seed=sum(PEAKED[1:6]))
    want = tflash.flash_bwd_plain(*args)
    assert _used(_kernel_bwd(*args, heavy=False)[0], want[0]) > 1.0
    assert _used(_kernel_bwd(*args)[0], want[0]) <= 1.0


def test_tf32_split_keeps_22_bits():
    """hi + lo recovers x to 2^-22 of its magnitude; ties round away."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_launch_refuses_a_delta_of_the_other_layout(monkeypatch,
                                                            dtype):
    """The fp32 kernels read delta as (B*H, S, 2) hi + lo, the bf16 ones as
    (B*H, S): the wrappers raise on the other layout before a launch."""
    from paddle_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "kernel", lambda name: pytest.fail(name))
    b, s, h, d = 2, 16, 4, 16
    q, k, v, out, do = (torch.randn(b, s, h, d).to(dtype) for _ in range(5))
    lse = torch.zeros(b * h, s)
    other = torch.zeros((b * h, s) if dtype == torch.float32 else
                        (b * h, s, 2))
    assert tflash.flash_delta(out, do, "bsnd").shape != other.shape
    with pytest.raises(ValueError, match="delta must be fp32"):
        tflash.flash_bwd_dq_cuda(q, k, v, out, lse, other, do, True, 0.25,
                                 None, "bsnd")
    with pytest.raises(ValueError, match="delta must be fp32"):
        tflash.flash_bwd_dkv_cuda(q, k, v, lse, other, do, True, 0.25, None,
                                  "bsnd")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_tf32_forward_holds_plain_within_flash_tol(case):
    """The fp32 forward's 3xTF32 arithmetic, tile by tile with exp2,
    within FLASH_TOL fp32 of flash_fwd_plain for out and lse."""
    args = _inputs(case, seed=sum(case[1:6]))
    q, k, v, causal, scale, window, layout = args[:3] + args[6:]
    got = _kernel_fwd(q, k, v, causal, scale, window, layout)
    want = tflash.flash_fwd_plain(q, k, v, causal, scale, window, layout)
    for name, x, y, tol in (("out", got[0], want[0], TOL),
                            ("lse", got[1], want[1], LSE_TOL)):
        assert x.shape == y.shape and x.dtype == torch.float32
        used = _used(x, y, tol)
        assert used <= 1.0, f"{name}: {used:.3f} of the bound"


@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=[IDS[0], IDS[5]])
def test_single_tf32_forward_misses_flash_tol(case):
    """The forward with one TF32 product for Q.K^T and P.V: out misses the
    bound by far (S keeps 11 bits of each operand), so the bound tells
    one product from three here too."""
    args = _inputs(case, seed=sum(case[1:6]))
    q, k, v, causal, scale, window, layout = args[:3] + args[6:]
    got = _kernel_fwd(q, k, v, causal, scale, window, layout, split=False)
    want = tflash.flash_fwd_plain(q, k, v, causal, scale, window, layout)
    assert _used(got[0], want[0]) > 10.0


@pytest.mark.parametrize("v3", [True, False], ids=["v-in-3-parts",
                                                   "v-in-2-parts"])
def test_one_key_query_gets_v_exactly(v3):
    """A causal first query sees one key (p = 1): its out is that key's v
    to the last bit only with V in three TF32 parts.  Two keep 22 of v's
    24 bits, and the backward's dp - delta (delta from this out) would
    not cancel to 0 there, as it does for flash_fwd_plain's out."""
    args = _inputs(CASES[0], seed=sum(CASES[0][1:6]))
    q, k, v, causal, scale, window, layout = args[:3] + args[6:]
    out, _ = _kernel_fwd(q, k, v, causal, scale, window, layout, v3=v3)
    first, want = out[:, :, 0], v[:, :, 0]       # bnsd: query / key 0
    assert torch.equal(first, want) == v3
