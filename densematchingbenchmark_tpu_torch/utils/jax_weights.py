"""Carry Flax variables into the port's modules, and the port's tensors
back into Flax-shaped trees.

``variables`` is the Flax ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (for example ``jax.tree.map(np.asarray, variables)``); this
module takes numpy only. Leaves are matched by tree path: the port names its
submodules after the Flax tree (``ConvUnit_0``, ``Conv_0``, ``BatchNorm_0``,
...), and a ``torch.nn.ModuleList`` entry ``name.<i>`` is Flax's
``name_<i>``. The trunk-packed (``pack=4``) and unpacked Flax trees are
identical, so one mapping serves every schedule. AcfNet's trees follow
the same names: the aggregator's ``ConvTransposeExact_0..2`` (its learned
upsamplers, in up1, up2, up3 order) and the cmn's ``ConfHead_<i>``.

Layout rules (the inverse of densematchingbenchmark_tpu/utils/
torch_convert.py:60-81):

  conv kernel [k..., I, O]                -> weight [O, I, k...]
  transposed-conv kernel [k..., I, O]     -> weight [I, O, k...] of the
      spatially flipped kernel (ConvTransposeExact is an input-dilated conv
      with the kernel not flipped, layers.py:104-111; torch's transposed
      conv applies the flipped kernel)
  BatchNorm scale / bias                  -> weight / bias
  BatchNorm batch_stats mean / var        -> running_mean / running_var
  a parameter of any other module (``self.param`` in Flax, for example
      models/cost_norm.CostVolumeNorm's weight and bias)
                                          -> the parameter of that name

Any leaf left unmatched on either side, or of the wrong shape, raises.
``flax_variables`` is the inverse direction with the same rules: it lays
the module's parameters (or per-parameter tensors such as gradients) and
BN statistics out as the Flax tree, for comparisons with the JAX package.
"""

import numpy as np
import torch
from torch import nn

_CONVS = (nn.Conv2d, nn.Conv3d)
_TRANSPOSED = (nn.ConvTranspose2d, nn.ConvTranspose3d)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_path(module_name):
    """'backbone.firstconv.0.Conv_0' -> ('backbone', 'firstconv_0',
    'Conv_0')."""
    path = []
    for part in module_name.split(".") if module_name else ():
        if part.isdigit():
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    return tuple(path)


def _torch_kernel(kernel, transposed):
    n = kernel.ndim - 2
    if transposed:
        kernel = kernel[(slice(None, None, -1),) * n]
        return np.transpose(kernel, (n, n + 1, *range(n)))
    return np.transpose(kernel, (n + 1, n, *range(n)))


def _flax_kernel(weight, transposed):
    n = weight.ndim - 2
    if transposed:
        kernel = np.transpose(weight, (*range(2, n + 2), 0, 1))
        return np.ascontiguousarray(kernel[(slice(None, None, -1),) * n])
    return np.transpose(weight, (*range(2, n + 2), 1, 0))


def flax_variables(model, values=None):
    """{"params": ..., "batch_stats": ...} numpy tree of ``model`` in the
    Flax layout. ``values``: optional {parameter name: tensor} (for
    example the gradients, keyed as ``model.named_parameters()``) laid out
    in place of the parameters; batch_stats are always the module's
    running statistics."""
    tree = {"params": {}, "batch_stats": {}}

    def put(kind, path, value):
        node = tree[kind]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    for name, m in model.named_modules():
        path = flax_path(name)

        def get(attr):
            full = f"{name}.{attr}" if name else attr
            t = values[full] if values is not None else getattr(m, attr)
            return t.detach().cpu().numpy()

        if isinstance(m, _CONVS + _TRANSPOSED):
            put("params", path + ("kernel",),
                _flax_kernel(get("weight"), isinstance(m, _TRANSPOSED)))
            if m.bias is not None:
                put("params", path + ("bias",), get("bias"))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            put("params", path + ("scale",), get("weight"))
            put("params", path + ("bias",), get("bias"))
            put("batch_stats", path + ("mean",),
                m.running_mean.detach().cpu().numpy())
            put("batch_stats", path + ("var",),
                m.running_var.detach().cpu().numpy())
        else:
            for attr, _ in m.named_parameters(recurse=False):
                put("params", path + (attr,), get(attr))
    return tree


def load_jax_variables(model, variables):
    """Copy the Flax ``variables`` into ``model`` in place; returns it."""
    leaves = {("params",) + p: v
              for p, v in _flatten(variables["params"]).items()}
    leaves.update({("batch_stats",) + p: v for p, v in
                   _flatten(variables.get("batch_stats", {})).items()})
    used = set()

    def take(key, target, convert=None):
        if key not in leaves:
            raise KeyError(f"no Flax leaf {'/'.join(key)} for {target}")
        value = leaves[key]
        if convert is not None:
            value = convert(value)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{'/'.join(key)}: shape {tuple(value.shape)} "
                             f"!= {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value)))
        used.add(key)

    for name, m in model.named_modules():
        path = flax_path(name)
        if isinstance(m, _CONVS + _TRANSPOSED):
            transposed = isinstance(m, _TRANSPOSED)
            take(("params",) + path + ("kernel",), m.weight,
                 lambda k: _torch_kernel(k, transposed))
            if m.bias is not None:
                take(("params",) + path + ("bias",), m.bias)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            take(("params",) + path + ("scale",), m.weight)
            take(("params",) + path + ("bias",), m.bias)
            take(("batch_stats",) + path + ("mean",), m.running_mean)
            take(("batch_stats",) + path + ("var",), m.running_var)
        else:
            for attr, param in m.named_parameters(recurse=False):
                take(("params",) + path + (attr,), param)
    unmatched = sorted("/".join(k) for k in set(leaves) - used)
    if unmatched:
        raise ValueError(f"{len(unmatched)} Flax leaves have no module in "
                         f"the port: {unmatched[:8]}")
    return model
