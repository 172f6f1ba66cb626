"""``FLAGS_check_nan_inf``: the eager tracer scans every op's float
outputs and raises naming the first op that produced a NaN or an Inf.

Counterpart of ``paddle_tpu/framework/nan_inf.py``
(``assert_all_finite_eager``, ``op_all_finite``,
``raise_first_bad_op``).  The eager check reads the outputs back to the
host, a synchronisation per op: a debugging flag's cost, as in the
reference.  The static executor keeps one finite flag per op on the
device (:func:`op_all_finite`) and reads them once, after the run
(:func:`raise_first_bad_op`).
"""

from __future__ import annotations

import torch


def _float_tensors(outs):
    for slot, vals in outs.items():
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for i, v in enumerate(vals):
            if isinstance(v, torch.Tensor) and (v.is_floating_point()
                                                or v.is_complex()):
                yield slot, i, v


def assert_all_finite_eager(op_type: str, outs) -> None:
    """Raise on the first non-finite float output of ``op_type``."""
    for slot, i, v in _float_tensors(outs):
        finite = torch.isfinite(v)
        if not bool(finite.all()):
            n_nan = int(torch.isnan(v).sum())
            n_inf = int(torch.isinf(v).sum())
            raise RuntimeError(
                f"FLAGS_check_nan_inf: op {op_type!r} output "
                f"{slot}[{i}] (shape {tuple(v.shape)}, dtype "
                f"{str(v.dtype).replace('torch.', '')}) contains {n_nan} "
                f"NaN and {n_inf} Inf values")


def op_all_finite(outs) -> torch.Tensor:
    """A 0-d bool tensor: every float output of this op is finite."""
    ok = None
    for _, _, v in _float_tensors(outs):
        f = torch.isfinite(v).all()
        ok = f if ok is None else ok & f
    return ok if ok is not None else torch.tensor(True)


def raise_first_bad_op(oks, op_labels) -> None:
    """Raise naming the first op whose finite flag is False."""
    flags = [bool(o) for o in oks]
    if all(flags):
        return
    idx = flags.index(False)
    raise RuntimeError(
        f"FLAGS_check_nan_inf: op #{idx} {op_labels[idx]} produced NaN/Inf "
        f"({flags.count(False)} op(s) non-finite in this step)")
