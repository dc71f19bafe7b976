"""Optimizer and learning-rate schedule.

Counterpart of densematchingbenchmark_tpu/trainer/optim.py: the
optax.chain(clip_by_global_norm(max_norm), <optimizer>(schedule),
paramwise scale) of the JAX package, written out with optax 0.2.6's
semantics, which differ from torch.optim's:

  g  <- g * min(1, max_norm / |g|)        clip at the global norm, before
                                          the optimizer
  rmsprop (decay = alpha 0.99, eps 1e-8, momentum 0):
    nu <- decay * nu + (1 - decay) * g^2  nu_0 = 0
    u  <- -lr(count) * g / sqrt(nu + eps) eps INSIDE the root (torch:
                                          sqrt(nu) + eps)
    u  <- u + momentum * t; t <- u        with momentum > 0: optax's trace
                                          of the lr-scaled updates
  adam (beta1 0.9, beta2 0.999, eps 1e-8):
    mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + (1 - b2) g^2
    u  <- -lr(count) * mu_hat / (sqrt(nu_hat) + eps), bias-corrected
          mu_hat = mu / (1 - b1^(count + 1)), eps OUTSIDE the root
  sgd (momentum 0.9):
    t  <- g + momentum * t;  u <- -lr(count) * t
  p  <- p + mult(p) * u                   count of updates, from 0

``mult`` is the paramwise post-update scale (:74-101): ``norm_lr_mult``
for BatchNorm parameters, ``bias_lr_mult`` for other biases, else 1. The
state lives on the parameters' device and the step reads nothing back to
the host.
"""

import torch

DECAY = 0.99
EPS = 1e-8


def make_lr_schedule(base_lr, schedule_cfg, steps_per_epoch):
    """mmcv step policy with linear warmup (:18-37): step -> lr."""
    warmup_iters = schedule_cfg.get("warmup_iters", 0)
    warmup_ratio = schedule_cfg.get("warmup_ratio", 1.0)
    gamma = schedule_cfg.get("gamma", 0.1)
    milestones = [int(e * steps_per_epoch)
                  for e in schedule_cfg.get("step", ())]

    def schedule(step):
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr *= gamma
        if warmup_iters > 0:
            frac = min(step / warmup_iters, 1.0)
            lr *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return lr

    return schedule


def _param_mult(name, options):
    if "BatchNorm" in name:
        return options.get("norm_lr_mult", 1.0)
    if name.endswith("bias"):
        return options.get("bias_lr_mult", 1.0)
    return 1.0


class _Optimizer:
    """One optax-style update over a fixed list of named parameters; a
    subclass's ``_updates`` turns the clipped gradients into updates
    before the learning rate, and names its state tensors in ``_STATE``."""

    _STATE = ()

    def __init__(self, named_params, schedule, max_norm=None,
                 paramwise=None):
        named_params = list(named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = schedule
        self.max_norm = max_norm
        self.mults = [_param_mult(n, paramwise or {}) for n in self.names]
        for key in self._STATE:
            setattr(self, key, [torch.zeros_like(p) for p in self.params])
        self.count = 0

    @torch.no_grad()
    def step(self, grads, grad_norm=None):
        """Apply one update from ``grads`` (one per parameter, in order).
        ``grad_norm``: their global norm, if the caller has it."""
        grads = list(grads)
        if self.max_norm is not None:
            if grad_norm is None:
                grad_norm = global_norm(grads)
            clip = torch.where(grad_norm < self.max_norm,
                               torch.ones_like(grad_norm),
                               self.max_norm / grad_norm)
            grads = torch._foreach_mul(grads, clip)
        updates, scale = self._updates(grads, self.schedule(self.count))
        for mult in set(self.mults):
            idx = [i for i, m in enumerate(self.mults) if m == mult]
            torch._foreach_add_([self.params[i] for i in idx],
                                [updates[i] for i in idx],
                                alpha=scale * mult)
        self.count += 1

    def state_dict(self):
        return {**{k: list(getattr(self, k)) for k in self._STATE},
                "count": self.count}

    def load_state_dict(self, state):
        with torch.no_grad():
            for key in self._STATE:
                for dst, src in zip(getattr(self, key), state[key]):
                    dst.copy_(src)
        self.count = int(state["count"])


class RMSprop(_Optimizer):
    """optax.rmsprop: eps inside the root, and with ``momentum`` > 0 a
    trace of the learning-rate-scaled updates."""

    def __init__(self, named_params, schedule, max_norm=None,
                 paramwise=None, decay=DECAY, eps=EPS, momentum=0.0):
        self._STATE = ("nu", "trace") if momentum else ("nu",)
        super().__init__(named_params, schedule, max_norm, paramwise)
        self.decay, self.eps, self.momentum = decay, eps, momentum

    def _updates(self, grads, lr):
        torch._foreach_mul_(self.nu, self.decay)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.decay)
        denom = torch._foreach_add(self.nu, self.eps)
        torch._foreach_sqrt_(denom)
        updates = torch._foreach_div(grads, denom)
        if not self.momentum:
            return updates, -lr
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(updates, self.trace, alpha=self.momentum)
        for dst, src in zip(self.trace, updates):
            dst.copy_(src)
        return updates, 1.0


class Adam(_Optimizer):
    """optax.adam: bias-corrected moments, eps outside the root."""

    _STATE = ("mu", "nu")

    def __init__(self, named_params, schedule, max_norm=None,
                 paramwise=None, b1=0.9, b2=0.999, eps=EPS):
        super().__init__(named_params, schedule, max_norm, paramwise)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _updates(self, grads, lr):
        torch._foreach_lerp_(self.mu, grads, 1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        t = self.count + 1
        mu_hat = torch._foreach_div(self.mu, 1 - self.b1 ** t)
        denom = torch._foreach_div(self.nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom), -lr


class SGD(_Optimizer):
    """optax.sgd: a trace of the gradients (momentum), then the learning
    rate."""

    _STATE = ("trace",)

    def __init__(self, named_params, schedule, max_norm=None,
                 paramwise=None, momentum=0.9):
        super().__init__(named_params, schedule, max_norm, paramwise)
        self.momentum = momentum

    def _updates(self, grads, lr):
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        return self.trace, -lr


def global_norm(tensors):
    """sqrt(sum of squares) over a list of tensors, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors))))


def build_optimizer(cfg, module, steps_per_epoch):
    """cfg['optimizer'] + cfg['lr_schedule'] + cfg['grad_clip'] -> (the
    optimizer over ``module``'s parameters, the schedule)."""
    opt_cfg = cfg["optimizer"]
    schedule = make_lr_schedule(opt_cfg["lr"], cfg.get("lr_schedule", {}),
                                steps_per_epoch)
    clip = cfg.get("grad_clip")
    common = dict(max_norm=clip["max_norm"] if clip else None,
                  paramwise=opt_cfg.get("paramwise_options"))
    kind = opt_cfg.get("type", "rmsprop").lower()
    if kind == "rmsprop":
        opt = RMSprop(module.named_parameters(), schedule,
                      decay=opt_cfg.get("alpha", DECAY),
                      eps=opt_cfg.get("eps", EPS),
                      momentum=opt_cfg.get("momentum", 0.0), **common)
    elif kind == "adam":
        opt = Adam(module.named_parameters(), schedule,
                   b1=opt_cfg.get("beta1", 0.9),
                   b2=opt_cfg.get("beta2", 0.999), **common)
    elif kind == "sgd":
        opt = SGD(module.named_parameters(), schedule,
                  momentum=opt_cfg.get("momentum", 0.9), **common)
    else:
        raise ValueError(f"unknown optimizer {kind}")
    return opt, schedule
