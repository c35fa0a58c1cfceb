"""Box-constrained quasi-Newton maximization (findmax_bfgs equivalent).

The port of ngsld_tpu/extras/optimize.py. The reference vendors an f2c
translation of Nocedal's L-BFGS-B for its sibling tools (shared/bfgs.cpp,
findmax_bfgs at bfgs.h:54 — vestigial, not compiled into ngsLD). This
module provides the same capability with a modern stack:

  * findmax(fn, x0, lower, upper)      — scipy L-BFGS-B on the host,
    numerical or user gradients (the reference's usage pattern), or
  * findmax_torch(fn, x0, ...)         — torch.optim.LBFGS with autograd
    gradients on a logistic box reparameterization, on the device of x0
    (the counterpart of the JAX package's findmax_jax).
"""

from __future__ import annotations

import numpy as np
import torch

# the gradient test of jax.scipy's BFGS (its default gtol), which
# findmax_jax's `converged` reports
GTOL = 1e-5


def findmax(fn, x0, lower=None, upper=None, grad=None, **kw):
    """Maximize fn over a box. Mirrors findmax_bfgs' contract: returns
    (x_opt, f_max, converged)."""
    from scipy.optimize import minimize
    x0 = np.asarray(x0, float)
    bounds = None
    if lower is not None or upper is not None:
        lo = np.full_like(x0, -np.inf) if lower is None else np.asarray(lower, float)
        hi = np.full_like(x0, np.inf) if upper is None else np.asarray(upper, float)
        bounds = list(zip(lo, hi))
    def neg(x):
        return -fn(x)

    jac = (lambda x: -np.asarray(grad(x))) if grad is not None else None
    res = minimize(neg, x0, jac=jac, method="L-BFGS-B", bounds=bounds, **kw)
    return res.x, -res.fun, bool(res.success)


def findmax_torch(fn, x0, lower=None, upper=None, maxiter: int = 200):
    """Box-constrained maximization on the device of x0, the counterpart of
    ngsld_tpu.extras.optimize.findmax_jax: the same logistic
    reparameterization of the box, autograd gradients, and a quasi-Newton
    step (torch.optim.LBFGS, strong-Wolfe line search) in the place of
    jax.scipy's BFGS. fn maps a tensor to a 0-dim tensor. x0 keeps its
    floating dtype (float32 otherwise, as findmax_jax casts). Returns
    (x_opt, f_max (0-dim), converged): converged when the gradient's
    largest entry in the reparameterized space is at most GTOL."""
    x0 = torch.as_tensor(x0)
    if not x0.is_floating_point():
        x0 = x0.to(torch.float32)
    if lower is None and upper is None:
        def to_x(z):
            return z
        z0 = x0
    else:
        lo = torch.as_tensor(lower, dtype=x0.dtype, device=x0.device)
        hi = torch.as_tensor(upper, dtype=x0.dtype, device=x0.device)

        def to_x(z):
            return lo + (hi - lo) * torch.sigmoid(z)

        p = torch.clamp((x0 - lo) / (hi - lo), 1e-6, 1 - 1e-6)
        z0 = torch.log(p) - torch.log1p(-p)

    z = z0.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([z], lr=1, max_iter=maxiter, tolerance_grad=GTOL,
                            line_search_fn="strong_wolfe")

    def neg():
        opt.zero_grad()
        loss = -fn(to_x(z))
        loss.backward()
        return loss

    opt.step(neg)
    loss = neg()
    converged = bool(z.grad.abs().max() <= GTOL)
    return to_x(z).detach(), -loss.detach(), converged
