"""Mixed-precision helpers: dynamic loss scaling, a finiteness test and a
per-leaf select over parameter or gradient trees.

Counterpart of densematchingbenchmark_tpu/utils/mixed_precision.py:23-67.
The port's compute policy is the JAX package's ``model.dtype="bfloat16"``:
float32 parameters and BN statistics, bfloat16 activations. bfloat16 has
float32's exponent range, so training needs no loss scaling and neither
trainer uses this module; ``DynamicLossScale`` is there for float16
targets, as in JAX. Its value and counter are tensors on the device and
``update`` decides with ``torch.where``, so a step that scales its loss
reads nothing back to the host.

A tree is a tensor, or a dict, list or tuple of trees (a ``state_dict``,
a dict of gradients).
"""

import dataclasses

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in _leaves(sub)]


def _map(fn, a, b):
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map(fn, v, b[k]) for k, v in a.items()}
    return type(a)(_map(fn, x, y) for x, y in zip(a, b))


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """Grow the scale after ``growth_interval`` finite steps in a row,
    halve it (never below 1) on a non-finite one.

    Usage:
      scale = DynamicLossScale.create(2.0 ** 15, device="cuda")
      grads = [g / scale.value for g in torch.autograd.grad(
          loss * scale.value, params)]
      finite = all_finite(grads)
      scale = scale.update(finite)
      # apply the step only where finite (select_tree, or skip it)
    """
    value: torch.Tensor
    counter: torch.Tensor
    growth_interval: int = 2000
    factor: float = 2.0

    @classmethod
    def create(cls, initial=2.0 ** 15, growth_interval=2000, factor=2.0,
               device=None):
        return cls(value=torch.tensor(initial, dtype=torch.float32,
                                      device=device),
                   counter=torch.tensor(0, dtype=torch.int32, device=device),
                   growth_interval=growth_interval, factor=factor)

    def update(self, grads_finite):
        """The scale after a step whose gradients were ``grads_finite`` (a
        0-d bool tensor)."""
        grow = (self.counter + 1) >= self.growth_interval
        value = torch.where(
            grads_finite,
            torch.where(grow, self.value * self.factor, self.value),
            torch.clamp_min(self.value / self.factor, 1.0))
        counter = torch.where(grads_finite & ~grow, self.counter + 1,
                              torch.zeros_like(self.counter))
        return dataclasses.replace(self, value=value, counter=counter)


def all_finite(tree):
    """0-d bool tensor: every leaf of ``tree`` is finite."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def select_tree(pred, true_tree, false_tree):
    """Per-leaf ``torch.where(pred, a, b)``: apply-or-skip for a scaled
    step."""
    return _map(lambda a, b: torch.where(pred, a, b), true_tree, false_tree)


__all__ = ["DynamicLossScale", "all_finite", "select_tree"]
