"""Optimizer and learning-rate schedule.

Counterpart of densematchingbenchmark_tpu/trainer/optim.py: the
optax.chain(clip_by_global_norm(35), rmsprop(schedule), paramwise scale)
of the JAX package, written out as one update with optax 0.2.6's
semantics, which differ from torch.optim.RMSprop's:

  g  <- g * min(1, max_norm / |g|)           clip at the global norm,
                                              before the optimizer
  nu <- decay * nu + (1 - decay) * g^2        nu_0 = 0, decay 0.99
  u  <- g / sqrt(nu + eps)                    eps INSIDE the root
                                              (torch: sqrt(nu) + eps),
                                              eps 1e-8
  p  <- p - schedule(count) * mult(p) * u     count of updates, from 0

``mult`` is the paramwise post-update scale (:74-101): ``norm_lr_mult``
for BatchNorm parameters, ``bias_lr_mult`` for other biases, else 1. The
state lives on the parameters' device and the step reads nothing back to
the host. decay and eps are the defaults that every config of the repo
uses; momentum (optax's trace) is not ported.
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


class RMSprop:
    """The update above over a fixed list of named parameters."""

    def __init__(self, named_params, schedule, max_norm=None,
                 paramwise=None):
        named_params = list(named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = schedule
        self.max_norm = max_norm
        self.mults = [_param_mult(n, paramwise or {}) for n in self.names]
        self.nu = [torch.zeros_like(p) for p in self.params]
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
        torch._foreach_mul_(self.nu, DECAY)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - DECAY)
        denom = torch._foreach_add(self.nu, EPS)
        torch._foreach_sqrt_(denom)
        updates = torch._foreach_div(grads, denom)
        lr = self.schedule(self.count)
        for mult in set(self.mults):
            idx = [i for i, m in enumerate(self.mults) if m == mult]
            torch._foreach_add_([self.params[i] for i in idx],
                                [updates[i] for i in idx],
                                alpha=-lr * mult)
        self.count += 1

    def state_dict(self):
        return {"nu": list(self.nu), "count": self.count}

    def load_state_dict(self, state):
        with torch.no_grad():
            for dst, src in zip(self.nu, state["nu"]):
                dst.copy_(src)
        self.count = int(state["count"])


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
    kind = opt_cfg.get("type", "rmsprop").lower()
    if kind != "rmsprop":
        raise NotImplementedError(
            f"optimizer {kind!r} is not ported yet (the PSMNet configs use "
            "rmsprop; ROADMAP.md queue 1)")
    for key, default in (("alpha", DECAY), ("eps", EPS), ("momentum", 0.0)):
        if opt_cfg.get(key, default) != default:
            raise NotImplementedError(
                f"rmsprop {key}={opt_cfg[key]!r} is not ported yet (only "
                f"the default {default!r}; ROADMAP.md queue 1 item 3)")
    clip = cfg.get("grad_clip")
    opt = RMSprop(module.named_parameters(), schedule,
                  max_norm=clip["max_norm"] if clip else None,
                  paramwise=opt_cfg.get("paramwise_options"))
    return opt, schedule
