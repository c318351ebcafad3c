"""Optimizers and learning-rate schedules, to optax 0.2.6's formulas.

Port of ``torch_fdtd_string_tpu/models/optim.py`` (reference
``src/utils/optimizer.py``): registries keyed by the ``optimizer`` and
``scheduler`` config groups (sgd, adam, adamw, radam, lamb, novograd;
constant, noam, step, multistep, cosine, cosine_warmup, linear_warmup,
constant_warmup, plateau, timm_cosine).

A schedule is a function of optax's update ``count`` (an int) to a
learning rate.  Each optimizer is a ``torch.optim.Optimizer`` that applies
what the JAX package's optax chain applies, in its order: the global-norm
clip, the optimizer's own scaling, its learning rate ``schedule(count)``
(so the first update uses ``schedule(0)``), then the reduce-on-plateau
scale.  ``count`` lives in every param group, so that it is saved and
loaded with the optimizer's ``state_dict()``.  ``torch.optim.RAdam``
applies eps before the bias correction of the second moment and rectifies
at ``rho > 5``, ``torch.optim`` has no LAMB, NovoGrad or noam schedule,
and ``clip_grad_norm_`` adds 1e-6 to the norm: every piece is written here
to optax's formula.  Nothing here reads a value back from the device: the
clip, the trust ratio and the plateau rule select with ``torch.where``.
"""

from __future__ import annotations

import math

import torch

# ---- schedules ------------------------------------------------------------------


def constant_schedule(value):
    return lambda count: value


def linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule`` (a polynomial of power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules, boundaries):
    """``optax.join_schedules``: each later schedule counts from its
    boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sch in zip(boundaries, schedules[1:]):
            out = out if count < boundary else sch(count - boundary)
        return out

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate, staircase=False):
    """``optax.exponential_decay`` from count 0."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if count <= 0 else init_value * decay_rate**p

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """``optax.piecewise_constant_schedule``: the scale of a boundary applies
    from that count on."""
    if any(s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("piecewise_constant_schedule expects non-negative scales")

    def schedule(count):
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = 1.0 if count < threshold else 0.0  # max(0, sign(threshold - count))
            v = v * indicator + (1 - indicator) * scale * v
        return v

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def noam_schedule(base_lr, warmup):
    def schedule(count):
        s = max(count, 1)
        return base_lr * (warmup**0.5) * min(s**-0.5, s * warmup**-1.5)

    return schedule


def get_schedule(name, base_lr, conf, total_steps=100000):
    """The schedule ``count -> lr`` of ``scheduler._name_`` ``name``."""
    if name is None or name == "constant":
        return constant_schedule(base_lr)
    name = name.lower()
    if name == "noam":
        return noam_schedule(base_lr, conf.get("warmup_steps", 1000))
    if name == "step":
        return exponential_decay(base_lr, conf.get("step_size", 20), conf.get("gamma", 0.99),
                                 staircase=True)
    if name == "multistep":
        bounds = {int(m): conf.get("gamma", 0.2) for m in conf.get("milestones", [])}
        return piecewise_constant_schedule(base_lr, bounds)
    if name == "cosine":
        return cosine_decay_schedule(base_lr, conf.get("T_max", total_steps),
                                     alpha=conf.get("eta_min", 1e-6) / base_lr)
    if name == "cosine_warmup":
        w = conf.get("num_warmup_steps", 500)
        n = conf.get("num_training_steps", total_steps)
        return join_schedules([linear_schedule(0.0, base_lr, w),
                               cosine_decay_schedule(base_lr, n - w, alpha=0.0)], [w])
    if name == "linear_warmup":
        w = conf.get("num_warmup_steps", 1000)
        n = conf.get("num_training_steps", total_steps)
        return join_schedules([linear_schedule(0.0, base_lr, w),
                               linear_schedule(base_lr, 0.0, max(n - w, 1))], [w])
    if name == "constant_warmup":
        w = conf.get("num_warmup_steps", 1000)
        return join_schedules([linear_schedule(0.0, base_lr, w), constant_schedule(base_lr)],
                              [w])
    if name in ("plateau", "timm_cosine"):
        # the plateau rule scales the updates (ReduceOnPlateau); the schedule
        # stays constant
        return constant_schedule(base_lr)
    raise NotImplementedError(name)


# ---- transformations --------------------------------------------------------------


def clip_by_global_norm(grads, max_norm):
    """``optax.clip_by_global_norm``: ``g`` below the norm, else
    ``g / norm * max_norm``."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau(factor, patience, min_scale)`` at
    the JAX package's other settings (rtol 1e-4, atol 0, cooldown 0,
    accumulation_size 1), fed the training loss every step: after
    ``patience`` steps without a loss below ``(1 - rtol)`` times the best,
    the scale of the updates is multiplied by ``factor`` (not below
    ``min_scale``).  Its state is 0-d tensors on the parameters' device:
    the rule selects there and never waits for the loss."""

    RTOL = 1e-4

    def __init__(self, factor=0.1, patience=10, min_scale=0.0, device=None,
                 dtype=torch.float32):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        self.factor, self.patience, self.min_scale = factor, patience, min_scale
        self.state = {"scale": torch.ones((), dtype=dtype, device=device),
                      "best_value": torch.full((), math.inf, dtype=torch.float64,
                                               device=device),
                      "plateau_count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, value):
        """Take one loss value; returns the scale for this step's update."""
        s = self.state
        value = value.detach().to(torch.float64)
        improved = value < (1 - self.RTOL) * s["best_value"]
        s["best_value"] = torch.where(improved, value, s["best_value"])
        plateau = torch.where(improved, torch.zeros_like(s["plateau_count"]),
                              s["plateau_count"] + 1)
        hit = plateau == self.patience
        s["scale"] = torch.clamp_min(torch.where(hit, s["scale"] * self.factor, s["scale"]),
                                     self.min_scale)
        s["plateau_count"] = torch.where(hit, torch.zeros_like(plateau), plateau)
        return s["scale"]

    def state_dict(self):
        return {k: v.detach().cpu() for k, v in self.state.items()}

    def load_state_dict(self, sd):
        for k, v in self.state.items():
            self.state[k] = sd[k].to(device=v.device, dtype=v.dtype)


class OptaxOptimizer(torch.optim.Optimizer):
    """The optax chain ``clip -> scaling -> schedule -> plateau`` as one
    ``torch.optim.Optimizer``.  Subclasses give ``_direction``: the scaled
    update of one parameter before the learning rate, at update count
    ``t`` (from 1).  A parameter without a gradient counts as a zero
    gradient, as the JAX package's gradient tree has a leaf for every
    parameter."""

    def __init__(self, params, schedule, defaults, grad_clip=None, plateau=None):
        super().__init__(params, dict(defaults, count=0))
        self.schedule = schedule if callable(schedule) else constant_schedule(schedule)
        self.grad_clip = grad_clip
        self.plateau = plateau

    @property
    def count(self):
        return self.param_groups[0]["count"]

    def set_count(self, count):
        """Set every group's update count (a resume without saved state)."""
        for group in self.param_groups:
            group["count"] = int(count)

    def lr(self):
        """The learning rate the next update applies: ``schedule(count)``."""
        return float(self.schedule(self.count))

    @torch.no_grad()
    def step(self, closure=None, value=None):
        """One update; ``value`` (the training loss, a tensor) feeds the
        plateau rule when there is one."""
        if closure is not None:
            raise ValueError("OptaxOptimizer takes no closure")
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.grad_clip:
            grads = clip_by_global_norm(grads, float(self.grad_clip))
        grad_of = dict(zip(map(id, params), grads))
        scale = None
        if self.plateau is not None:
            if value is None:
                raise ValueError("the plateau rule needs the loss: step(value=loss)")
            scale = self.plateau.update(value)
        for group in self.param_groups:
            count = group["count"]
            lr = float(self.schedule(count))
            for p in group["params"]:
                u = self._direction(p, grad_of[id(p)], self.state[p], group, count + 1)
                u = torch.mul(u, -lr)
                if scale is not None:
                    u = scale.to(u.dtype) * u
                p.add_(u)
            group["count"] = count + 1

    def state_dict(self):
        sd = super().state_dict()
        if self.plateau is not None:
            sd["plateau"] = self.plateau.state_dict()
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        plateau = state_dict.pop("plateau", None)
        super().load_state_dict(state_dict)
        if self.plateau is not None and plateau is not None:
            self.plateau.load_state_dict(plateau)

    def _direction(self, p, g, state, group, t):
        raise NotImplementedError


def _leaf_norm(x, p):
    """The norm of ``x`` over each layer of parameter ``p``, as optax takes
    a layer: the whole tensor, or each element where ``p`` stacks scalar
    leaves of the JAX package's tree (``p.stacked_leaves``, the MLP's PReLU
    slopes)."""
    return x.abs() if getattr(p, "stacked_leaves", False) else torch.linalg.vector_norm(x)


def _ipow(base, n):
    """``base ** n`` for an int ``n`` by squaring, as XLA raises a float to
    an integer count: RAdam's rho differences large numbers near its
    threshold, where one ulp of ``b2 ** t`` shows."""
    out = 1.0
    while n:
        if n & 1:
            out *= base
        base *= base
        n >>= 1
    return out


def _adam_direction(g, state, b1, b2, eps, t):
    """``optax.scale_by_adam``: the bias-corrected moments' ratio."""
    if "mu" not in state:
        state["mu"], state["nu"] = torch.zeros_like(g), torch.zeros_like(g)
    state["mu"] = (1 - b1) * g + b1 * state["mu"]
    state["nu"] = (1 - b2) * g**2 + b2 * state["nu"]
    mu_hat = state["mu"] / (1 - _ipow(b1, t))
    nu_hat = state["nu"] / (1 - _ipow(b2, t))
    return mu_hat, nu_hat, mu_hat / (torch.sqrt(nu_hat) + eps)


class SGD(OptaxOptimizer):
    """``optax.sgd`` (``trace`` momentum, not Nesterov)."""

    def __init__(self, params, lr, momentum=0.9, **kw):
        super().__init__(params, lr, dict(momentum=momentum), **kw)

    def _direction(self, p, g, state, group, t):
        if group["momentum"] is None:
            return g
        trace = state.get("trace", torch.zeros_like(g))
        state["trace"] = g + group["momentum"] * trace
        return state["trace"]


class Adam(OptaxOptimizer):
    """``optax.adam``; with ``weight_decay``, ``optax.adamw`` (decoupled:
    ``+ wd * p`` after the scaling, before the learning rate)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **kw):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps,
                                          weight_decay=weight_decay), **kw)

    def _direction(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        u = _adam_direction(g, state, b1, b2, group["eps"], t)[2]
        return u + group["weight_decay"] * p if group["weight_decay"] else u


class RAdam(OptaxOptimizer):
    """``optax.radam``: the rectified update where ``rho_t >= threshold``,
    the bias-corrected first moment below it; eps after the square root
    of the bias-corrected second moment."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, threshold=5.0, **kw):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps, threshold=threshold),
                         **kw)

    def _direction(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        mu_hat, nu_hat, _ = _adam_direction(g, state, b1, b2, group["eps"], t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _ipow(b2, t)
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        if ro < group["threshold"]:
            return mu_hat
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return torch.mul(mu_hat, r) / (torch.sqrt(nu_hat) + group["eps"])


class Lamb(OptaxOptimizer):
    """``optax.lamb``: Adam's scaling (eps 1e-6), decoupled weight decay,
    then the layer-wise trust ratio ``||p|| / ||u||`` (1 where either is
    0)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0, **kw):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps,
                                          weight_decay=weight_decay), **kw)

    def _direction(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        u = _adam_direction(g, state, b1, b2, group["eps"], t)[2] + group["weight_decay"] * p
        p_norm, u_norm = _leaf_norm(p, p), _leaf_norm(u, p)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm)
        return u * ratio


class NovoGrad(OptaxOptimizer):
    """``optax.novograd`` (b2 0.25, eps 1e-6): a per-layer second moment of
    the squared gradient norm, first taken as is."""

    def __init__(self, params, lr, betas=(0.9, 0.25), eps=1e-6, weight_decay=0.0, **kw):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps,
                                          weight_decay=weight_decay), **kw)

    def _direction(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        sq = _leaf_norm(g, p) ** 2
        # moments not yet in the state (a resume without saved state) are 0
        nu = sq if t == 1 else (1 - b2) * sq + b2 * state.get("nu", torch.zeros_like(sq))
        step = g / (torch.sqrt(nu) + group["eps"]) + group["weight_decay"] * p
        state["nu"] = nu
        state["mu"] = step if t == 1 else b1 * state.get("mu", torch.zeros_like(g)) + step
        return state["mu"]


def get_optimizer(name, conf, params, grad_clip=None, plateau=None):
    """The optimizer ``optimizer._name_`` ``name`` over ``params``;
    ``conf["lr"]`` is a learning rate or a schedule."""
    name = name.lower()
    lr = conf.get("lr", 1e-3)
    kw = dict(grad_clip=grad_clip, plateau=plateau)
    if name == "sgd":
        return SGD(params, lr, momentum=conf.get("momentum", 0.9), **kw)
    if name == "adam":
        return Adam(params, lr, betas=conf.get("betas", (0.9, 0.999)), **kw)
    if name == "adamw":
        return Adam(params, lr, betas=conf.get("betas", (0.9, 0.999)),
                    weight_decay=conf.get("weight_decay", 0.001), **kw)
    if name == "radam":
        return RAdam(params, lr, **kw)
    if name == "lamb":
        return Lamb(params, lr, weight_decay=conf.get("weight_decay", 0.0), **kw)
    if name == "novograd":
        return NovoGrad(params, lr, **kw)
    raise NotImplementedError(name)


def build(params, opt_name, opt_conf, sch_name, sch_conf, grad_clip=None, total_steps=None):
    """Returns ``(optimizer, schedule, needs_value)``.

    ``needs_value`` means ``optimizer.step`` takes ``value=loss`` (the
    plateau rule, driven by the training loss every step).
    ``total_steps`` is the real run length (epochs x steps per epoch), so
    that the cosine and warm-up schedules decay over the actual horizon."""
    params = list(params)
    base_lr = opt_conf.get("lr", 1e-3)
    schedule = get_schedule(sch_name, base_lr, sch_conf or {},
                            **({"total_steps": int(total_steps)} if total_steps else {}))
    plateau = None
    if sch_name and sch_name.lower() == "plateau":
        sc = sch_conf or {}
        plateau = ReduceOnPlateau(factor=sc.get("factor", 0.2), patience=sc.get("patience", 20),
                                  min_scale=sc.get("min_lr", 0.0) / max(base_lr, 1e-12),
                                  device=params[0].device, dtype=params[0].dtype)
    conf = dict(opt_conf, lr=schedule)
    optimizer = get_optimizer(opt_name, conf, params,
                              grad_clip=float(grad_clip) if grad_clip else None, plateau=plateau)
    return optimizer, schedule, plateau is not None
