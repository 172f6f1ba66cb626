"""``FLAGS_check_nan_inf``: the eager tracer scans every op's float
outputs and raises naming the first op that produced a NaN or an Inf.

Counterpart of ``paddle_tpu/framework/nan_inf.py``
(``assert_all_finite_eager``).  The check reads the outputs back to the
host, a synchronisation per op: a debugging flag's cost, as in the
reference.  The static executor's per-op finite vector waits for graph
mode (ROADMAP A.10).
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
