"""Hand-rolled functional optimizers on trees of tensors (port of
``repro.optim.optimizers``).

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    new_params, new_state = opt.apply(params, grads, state, lr_scale=1.0)

Arithmetic is float32 whatever the parameters' dtype; ``lr_scale`` is the
hook the spectral governor (``optim/spectral_adapt.py``) drives.  A state
from the JAX package's optimizers (numpy leaves) carries across with
``repro_torch.tree.tree_from_numpy``: same keys, same shapes, ``count``
int32.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    apply: Callable[..., Any]
    name: str


def _count(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _unzip(params, out, n: int):
    """Split ``out`` (``params``' structure, an n-tuple at each leaf) into
    n trees."""
    return [tree_map(lambda _, t: t[i], params, out) for i in range(n)]


def sgd(lr: float = 1e-2, momentum: float = 0.9):
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "count": _count(params)}

    def apply(params, grads, state, lr_scale=1.0):
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                      state["mu"], grads)
        new_params = tree_map(
            lambda p, m: (p.to(_F32) - lr * lr_scale * m.to(_F32)
                          ).to(p.dtype), params, mu)
        return new_params, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, apply, "sgd")


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype=torch.float32):
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count(params)}

    def apply(params, grads, state, lr_scale=1.0):
        c = state["count"] + 1
        bc1 = 1.0 - b1 ** c.to(_F32)
        bc2 = 1.0 - b2 ** c.to(_F32)

        def upd(p, g, m, v):
            gf = g.to(_F32)
            mn = b1 * m.to(_F32) + (1 - b1) * gf
            vn = b2 * v.to(_F32) + (1 - b2) * gf * gf
            step = (mn / bc1) / (torch.sqrt(vn / bc2) + eps)
            step = step + weight_decay * p.to(_F32)
            pn = p.to(_F32) - lr * lr_scale * step
            return (pn.to(p.dtype), mn.to(state_dtype), vn.to(state_dtype))

        new_params, m, v = _unzip(
            params, tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_params, {"m": m, "v": v, "count": c}

    return Optimizer(init, apply, "adamw")


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    """Factored second-moment optimizer (Shazeer & Stern 2018): a
    parameter with two or more axes keeps its second moment as row and
    column factors over the trailing two axes, O(m + n) state."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def zeros(p):
            z = dict(dtype=_F32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"v": tree_map(zeros, params), "count": _count(params)}

    def apply(params, grads, state, lr_scale=1.0):
        c = state["count"] + 1
        beta = 1.0 - c.to(_F32) ** -decay

        def upd(p, g, v):
            gf = g.to(_F32)
            g2 = gf * gf + eps
            if _factored(p):
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)
                                       [..., None], min=eps))
                step = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                vn = beta * v["v"] + (1 - beta) * g2
                step = gf * torch.rsqrt(torch.clamp(vn, min=eps))
                nv = {"v": vn}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                step = step + weight_decay * p.to(_F32)
            pn = p.to(_F32) - lr * lr_scale * step
            return pn.to(p.dtype), nv

        new_params, new_v = _unzip(
            params, tree_map(upd, params, grads, state["v"]), 2)
        return new_params, {"v": new_v, "count": c}

    return Optimizer(init, apply, "adafactor")


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
