"""Optimizer update ops, the gradient clip by norm and the AMP loss
scaling ops.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py``, op for op: each is a
functional update ``ParamOut = f(Param, Grad, state...)`` in the
reference's order of operations (Adam's bias correction folded into the
learning rate, AdamW's decay of the parameter before the Adam update,
the beta powers carried as [1] tensors).  The optimizers write the
outputs back into their parameters and accumulators.
"""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("sgd", no_grad=True)
def sgd_kernel(ins, attrs):
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    return {"ParamOut": p - lr.to(p.dtype) * g.to(p.dtype)}


@register_op("momentum", no_grad=True)
def momentum_kernel(ins, attrs):
    p, g, v, lr = ins["Param"], ins["Grad"], ins["Velocity"], \
        ins["LearningRate"]
    mu = attrs.get("mu", 0.9)
    rd = attrs.get("regularization_coeff", 0.0)
    if attrs.get("regularization_method", "") == "l2_decay" and rd:
        g = g + rd * p
    lr = lr.to(p.dtype)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam", no_grad=True)
def adam_kernel(ins, attrs):
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"], ins["Beta2Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.to(m1.dtype)
    m1o = b1 * m1 + (1.0 - b1) * gf
    m2o = b2 * m2 + (1.0 - b2) * torch.square(gf)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p_out = p - (lr_t * m1o / (torch.sqrt(m2o) + eps)).to(p.dtype)
    return {"ParamOut": p_out, "Moment1Out": m1o, "Moment2Out": m2o,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("adamw", no_grad=True)
def adamw_kernel(ins, attrs):
    """Decoupled weight decay: the parameter scaled by
    ``1 - lr * coeff * lr_ratio``, then the Adam update."""
    coeff = attrs.get("coeff", 0.01)
    lr_ratio = attrs.get("lr_ratio", 1.0)
    p, lr = ins["Param"], ins["LearningRate"]
    if attrs.get("with_decay", True):
        p = p * (1.0 - lr * coeff * lr_ratio).to(p.dtype)
    return adam_kernel({**ins, "Param": p}, attrs)


@register_op("lamb", no_grad=True)
def lamb_kernel(ins, attrs):
    """Layer-adaptive learning rate (large-batch training)."""
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"], ins["Beta2Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    gf = g.to(m1.dtype)
    m1o = b1 * m1 + (1.0 - b1) * gf
    m2o = b2 * m2 + (1.0 - b2) * torch.square(gf)
    m1h = m1o / (1.0 - b1p)
    m2h = m2o / (1.0 - b2p)
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p.to(m1.dtype)
    w_norm = torch.linalg.vector_norm(p.float())
    r_norm = torch.linalg.vector_norm(r.float())
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    p_out = p - (ratio * lr * r).to(p.dtype)
    return {"ParamOut": p_out, "Moment1Out": m1o, "Moment2Out": m2o,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("rmsprop", no_grad=True)
def rmsprop_kernel(ins, attrs):
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    ms, mom = ins["MeanSquare"], ins["Moment"]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1.0 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg = ins["MeanGrad"]
        mg_out = rho * mg + (1.0 - rho) * g
        denom = torch.sqrt(ms_out - torch.square(mg_out) + eps)
        mom_out = mu * mom + lr * g / denom
        return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
                "MomentOut": mom_out, "MeanGradOut": mg_out}
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
            "MomentOut": mom_out}


@register_op("adagrad", no_grad=True)
def adagrad_kernel(ins, attrs):
    p, g, lr, mom = ins["Param"], ins["Grad"], ins["LearningRate"], \
        ins["Moment"]
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_out) + eps),
            "MomentOut": mom_out}


@register_op("lars_momentum", no_grad=True)
def lars_momentum_kernel(ins, attrs):
    """Layer-wise adaptive rate scaling."""
    p, g, v, lr = ins["Param"], ins["Grad"], ins["Velocity"], \
        ins["LearningRate"]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    p_norm = torch.linalg.vector_norm(p.float())
    g_norm = torch.linalg.vector_norm(g.float())
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


@register_op("clip_by_norm")
def clip_by_norm_kernel(ins, attrs):
    x = ins["X"]
    max_norm = attrs.get("max_norm", 1.0)
    n = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(n > max_norm, max_norm / torch.clamp_min(n, 1e-12),
                        torch.ones_like(n))
    return {"Out": x * scale.to(x.dtype)}


@register_op("check_finite_and_unscale", list_slots=("X", "Out"),
             no_grad=True)
def check_finite_and_unscale_kernel(ins, attrs):
    """Gradients unscaled by 1 / loss_scale, and whether any is not
    finite."""
    inv = 1.0 / ins["Scale"]
    found_inf = torch.zeros((), dtype=torch.bool, device=inv.device)
    outs = []
    for x in ins["X"]:
        xf = x.float() * inv
        found_inf = found_inf | ~torch.isfinite(xf).all()
        outs.append(xf.to(x.dtype))
    return {"Out": outs, "FoundInfinite": found_inf}


@register_op("update_loss_scaling", list_slots=("X", "Out"), no_grad=True)
def update_loss_scaling_kernel(ins, attrs):
    """The dynamic loss scale's state machine."""
    xs = ins["X"]
    found_inf = ins["FoundInfinite"]
    scale = ins["PrevLossScaling"]
    good, bad = ins["InGoodSteps"], ins["InBadSteps"]
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    good_out = torch.where(found_inf, torch.zeros_like(good), good + 1)
    bad_out = torch.where(found_inf, bad + 1, torch.zeros_like(bad))
    scale_out = torch.where(
        found_inf,
        torch.where(bad_out >= decr_every,
                    torch.clamp_min(scale * decr_ratio, 1.0), scale),
        torch.where(good_out >= incr_every, scale * incr_ratio, scale))
    bad_out = torch.where(bad_out >= decr_every, torch.zeros_like(bad_out),
                          bad_out)
    good_out = torch.where(good_out >= incr_every,
                           torch.zeros_like(good_out), good_out)
    if attrs.get("stop_update", False) is False:
        outs = [torch.where(found_inf, torch.zeros_like(x), x) for x in xs]
    else:
        outs = list(xs)
    return {"Out": outs, "LossScaling": scale_out, "OutGoodSteps": good_out,
            "OutBadSteps": bad_out}


@register_op("adadelta", no_grad=True)
def adadelta_kernel(ins, attrs):
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    avg_sq_grad, avg_sq_upd = ins["AvgSquaredGrad"], ins["AvgSquaredUpdate"]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_grad + (1.0 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_sq_upd + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_upd + (1.0 - rho) * torch.square(upd)
    return {"ParamOut": p + lr * upd, "AvgSquaredGradOut": g2,
            "AvgSquaredUpdateOut": u2}


@register_op("adamax", no_grad=True)
def adamax_kernel(ins, attrs):
    """Adam over the infinity norm."""
    p, g, lr = ins["Param"], ins["Grad"], ins["LearningRate"]
    m, inf = ins["Moment"], ins["InfNorm"]
    b1p = ins["Beta1Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    p_out = p - (lr / (1.0 - b1p)) * (m_out / (inf_out + eps))
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out,
            "Beta1PowOut": b1p * b1}
