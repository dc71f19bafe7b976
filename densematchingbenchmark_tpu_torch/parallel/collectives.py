"""The collectives that make N processes compute one global batch.

JAX's data parallelism is one computation over the global batch sharded
on a mesh (densematchingbenchmark_tpu/trainer/train_step.py:1-13): BN
statistics over the global batch, every masked mean a global sum over a
global count, the gradient that of the global loss. Here each process
holds its slice of the batch, and:

- ``global_sum`` all-reduces a tensor and is differentiable (its backward
  all-reduces the gradient), so a BN's global statistics pass every rank's
  gradient through them;
- a loss divides its rank's sum by the global count, so that the ranks'
  losses sum to the global loss, and ``all_reduce_grads`` sums their
  gradients into its gradient;
- ``broadcast_module`` makes every rank start from rank 0's tensors.

Without a process group each is the identity and runs nothing. Every call
that runs a collective adds one to ``collective_counts()`` under its name.
"""

import torch
import torch.distributed as dist

_COUNTS = {"all_reduce": 0, "broadcast": 0, "all_gather": 0, "barrier": 0}


def reset_collective_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def collective_counts():
    return dict(_COUNTS)


def in_group():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if in_group() else 0


def world_size():
    return dist.get_world_size() if in_group() else 1


def _all_reduce(t):
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's input is the sum
    of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _GlobalSum.apply(grad)


def global_sum(t):
    """``t`` summed over the ranks (differentiable); ``t`` itself outside
    a group."""
    return _GlobalSum.apply(t) if in_group() else t


def global_count(count):
    """A loss's count of valid elements over the global batch, without a
    gradient."""
    if not in_group():
        return count
    with torch.no_grad():
        return _all_reduce(count.detach().clone())


def all_reduce_(t):
    """Sum ``t`` over the ranks in place (no gradient); returns it."""
    return _all_reduce(t) if in_group() else t


def all_reduce_grads(grads):
    """Sum a list of gradients over the ranks in one all-reduce of one
    flattened float32 buffer; returns the summed list."""
    if not in_group():
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _all_reduce(flat)
    out, pos = [], 0
    for g in grads:
        out.append(flat[pos:pos + g.numel()].view_as(g).to(g.dtype))
        pos += g.numel()
    return out


def broadcast_module(module, src=0):
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module``: one broadcast a dtype."""
    if not in_group():
        return module
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            _COUNTS["broadcast"] += 1
            dist.broadcast(flat, src)
            pos = 0
            for t in ts:
                t.copy_(flat[pos:pos + t.numel()].view_as(t))
                pos += t.numel()
    return module


def all_gather_object(obj):
    """[every rank's ``obj``], in rank order; [obj] outside a group."""
    if not in_group():
        return [obj]
    out = [None] * world_size()
    _COUNTS["all_gather"] += 1
    dist.all_gather_object(out, obj)
    return out


def barrier():
    if in_group():
        _COUNTS["barrier"] += 1
        dist.barrier()


def collective_device():
    """Where a collective's own tensors live: the rank's GPU under NCCL,
    the host under gloo."""
    if in_group() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
