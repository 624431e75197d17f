"""Adam over parameters held in a 16-bit dtype (``train.param_dtype``
bfloat16 or float16), in optax's order of operations and rounding.

The JAX package's optimizer is ``optax.inject_hyperparams(adam)(lr, b1=0.9,
b2=0.99)``; over bfloat16 parameters optax keeps ``mu`` and ``nu`` in the
parameter dtype, casts the injected learning rate to it (also the float32
one that the JAX Learner's ``_set_lr`` writes), and rounds every step of the
update to it, with each Python constant rounded first:

    mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
    mu_hat = mu / (1 - b1^t)           nu_hat = nu / (1 - b2^t)
    u = -lr (mu_hat / (sqrt(nu_hat) + eps))                p = p + u

where ``1 - b^t`` is computed in float32 and then rounded.
``torch.optim.Adam`` orders the same terms otherwise (``exp_avg /
(sqrt(exp_avg_sq) / sqrt(1 - b2^t) + eps)``, constants unrounded), so the
Learner takes it for float32 parameters only, whose numbers it keeps.

The state keeps ``torch.optim.Adam``'s names (``step``, ``exp_avg``,
``exp_avg_sq``), so checkpoints hold either optimizer alike.
"""

from __future__ import annotations

import torch


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (to nearest, even), as a Python float:
    a weakly typed constant in a JAX expression of that dtype."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


class HalfAdam(torch.optim.Optimizer):
    """Adam in optax's arithmetic, each parameter in its own dtype (see the
    module's note)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.99),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("HalfAdam takes no closure")
        for group in self.param_groups:
            # one set of multi-tensor ops for the parameters of one dtype,
            # device and step count (the same arithmetic as one at a time)
            batches = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                key = (p.dtype, p.device, int(state["step"]))
                batches.setdefault(key, []).append(p)
            for (dt, _, t), params in batches.items():
                self._update(params, group, dt, t)

    def _update(self, params, group, dt, t):
        b1, b2 = group["betas"]
        grads = [p.grad for p in params]
        mus = [self.state[p]["exp_avg"] for p in params]
        nus = [self.state[p]["exp_avg_sq"] for p in params]
        # each product and sum rounds to dt, as the bfloat16 ops of optax
        torch._foreach_mul_(mus, _rounded(b1, dt))
        torch._foreach_add_(mus, torch._foreach_mul(grads, _rounded(1.0 - b1,
                                                                    dt)))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, _rounded(1.0 - b2, dt))
        torch._foreach_mul_(nus, _rounded(b2, dt))
        torch._foreach_add_(nus, sq)
        one = torch.tensor(1.0)
        bc1 = _rounded(float(one - torch.tensor(b1) ** t), dt)
        bc2 = _rounded(float(one - torch.tensor(b2) ** t), dt)
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, _rounded(group["eps"], dt))
        upd = torch._foreach_div(torch._foreach_div(mus, bc1), den)
        torch._foreach_mul_(upd, -_rounded(group["lr"], dt))
        torch._foreach_add_(params, upd)

def make_adam(params, lr: float, betas=(0.9, 0.99),
              eps: float = 1e-8) -> torch.optim.Optimizer:
    """``optax.adam(lr, *betas, eps)`` over ``params``: ``torch.optim.Adam``
    where every parameter is float32 or float64 (the port's float32
    numbers), else :class:`HalfAdam`, whose arithmetic is optax's in each
    parameter's own dtype (loaded float32 leaves beside bfloat16 ones, as
    the JAX package holds them after pretrained weights, take it too)."""
    params = list(params)
    if {p.dtype for p in params} <= {torch.float32, torch.float64}:
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    return HalfAdam(params, lr, betas=betas, eps=eps)
