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

On a (data, model) grid (parallel/mesh.py) a cost volume may be split
along D over the ranks of a model group, and three collectives move it
(``halo_exchange``, ``gather_d``, ``shard_d``; each an autograd Function
whose backward is the adjoint of its forward). Every reduction above
still runs over the whole world, and that keeps JAX's numbers:

- in a D-split region each rank holds other planes, so a world sum adds
  every element of the global batch once;
- in a replicated region (the gathered volume, the backbone, the losses)
  the n_model ranks of a data index hold the same values, so a BN's sum
  and its count, and a loss's count, come out n_model times theirs: the
  means and variances are the global batch's, and each rank's loss is
  1 / n_model of its data shard's share, so that the world's losses
  still sum to the global loss;
- with adjoint backwards, each rank's gradient is its part of the
  gradient of that sum, and ``all_reduce_grads`` sums the parts into the
  gradient of the global loss.

Without a process group each is the identity and runs nothing. Every call
that runs a collective adds one to ``collective_counts()`` under its kind
and the bytes of the buffer it hands the collective to
``collective_bytes()``; the D-axis collectives also count their calls,
forward and backward, in ``d_axis_counts()``.
"""

import torch
import torch.distributed as dist

_KINDS = ("all_reduce", "broadcast", "all_gather", "barrier")
_COUNTS = dict.fromkeys(_KINDS, 0)
_BYTES = dict.fromkeys(_KINDS, 0)
_D_OPS = ("halo_exchange", "halo_exchange_backward", "gather_d",
          "gather_d_backward")
_D_COUNTS = dict.fromkeys(_D_OPS, 0)


def reset_collective_counts():
    for counts in (_COUNTS, _BYTES, _D_COUNTS):
        for k in counts:
            counts[k] = 0


def collective_counts():
    return dict(_COUNTS)


def collective_bytes():
    return dict(_BYTES)


def d_axis_counts():
    return dict(_D_COUNTS)


def _count(kind, t):
    _COUNTS[kind] += 1
    _BYTES[kind] += t.numel() * t.element_size()


def in_group():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if in_group() else 0


def world_size():
    return dist.get_world_size() if in_group() else 1


def _all_reduce(t, group=None):
    _count("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
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
            _count("broadcast", flat)
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


# D-axis collectives of a (data, model) grid (parallel/mesh.py), on
# [B, D, ...] tensors split along D over the model group as
# torch.tensor_split splits them

def _splits(mesh):
    return mesh is not None and mesh.n_model > 1


def d_bounds(size, n):
    """[(lo, hi)] of each of ``n`` model ranks on a D of ``size``, as
    ``torch.tensor_split`` splits it (the first size % n ranks one plane
    more)."""
    if size < n:
        raise ValueError(f"D = {size} over {n} model ranks leaves a rank "
                         "no plane")
    per, extra = divmod(size, n)
    return [(i * per + min(i, extra), (i + 1) * per + min(i + 1, extra))
            for i in range(n)]


def d_planes(size, mesh):
    """(lo, hi): this rank's planes of a D of ``size``."""
    return d_bounds(size, mesh.n_model)[mesh.model_index]


def _gather_model(t, mesh):
    """[k, ...] of every rank of the model group, stacked in model order:
    [n_model * k, ...] on ``t``'s device, by one all-gather on the
    collective's device (``collective_device``: the host under gloo)."""
    src = t.contiguous().to(collective_device())
    out = src.new_empty((mesh.n_model * src.shape[0], *src.shape[1:]))
    _count("all_gather", src)
    _all_gather_single(out, src, group=mesh.model_group)
    return out.to(t.device)


def _all_gather_single(out, src, group):
    # torch renamed all_gather_into_tensor; both take these arguments
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, src, group=group)


def _edges(x, width):
    """The first and the last ``width`` planes of D, D moved first:
    [2 width, B, ...]."""
    xd = x.movedim(1, 0)
    return torch.cat([xd[:width], xd[-width:]])


class _HaloExchange(torch.autograd.Function):
    """[B, d, ...] -> [B, d + 2 width, ...]: the previous rank's last and
    the next rank's first ``width`` planes around this rank's, zeros past
    the ends of D. Backward: the halos' gradients go back to the ranks
    whose planes they are and are added there."""

    @staticmethod
    def forward(ctx, x, mesh, width):
        ctx.mesh, ctx.width = mesh, width
        i, n, d = mesh.model_index, mesh.n_model, x.shape[1]
        if d < width:
            raise ValueError(f"{d} planes, halo {width}")
        _D_COUNTS["halo_exchange"] += 1
        edges = _gather_model(_edges(x, width), mesh).unflatten(
            0, (n, 2 * width))
        out = x.new_zeros((x.shape[0], d + 2 * width, *x.shape[2:]))
        out[:, width:width + d] = x
        if i > 0:
            out[:, :width] = edges[i - 1, width:].movedim(0, 1)
        if i < n - 1:
            out[:, width + d:] = edges[i + 1, :width].movedim(0, 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh, width = ctx.mesh, ctx.width
        i, n = mesh.model_index, mesh.n_model
        _D_COUNTS["halo_exchange_backward"] += 1
        edges = _gather_model(_edges(grad, width), mesh).unflatten(
            0, (n, 2 * width))
        gx = grad[:, width:-width].clone(memory_format=torch.contiguous_format)
        if i > 0:      # the previous rank's right halo is my first planes
            gx[:, :width] += edges[i - 1, width:].movedim(0, 1)
        if i < n - 1:  # the next rank's left halo is my last planes
            gx[:, -width:] += edges[i + 1, :width].movedim(0, 1)
        return gx, None, None


def halo_exchange(x, mesh, width=1):
    """This rank's planes of D with ``width`` planes of each neighbour's
    on each side (zeros at the ends of D): what a stride-1 window of
    half-width ``width`` over D needs. ``x`` itself, unextended, outside
    a D split."""
    if not _splits(mesh):
        return x
    return _HaloExchange.apply(x, mesh, width)


class _GatherD(torch.autograd.Function):
    """[B, d_i, ...] on model rank i -> [B, size, ...] on every rank.
    Backward: the sum of the ranks' gradients of the whole (one
    all-reduce over the model group), then this rank's planes."""

    @staticmethod
    def forward(ctx, x, mesh, size):
        ctx.mesh, ctx.size = mesh, size
        n = mesh.n_model
        lo, hi = d_planes(size, mesh)
        if x.shape[1] != hi - lo:
            raise ValueError(f"model rank {mesh.model_index} holds "
                             f"{x.shape[1]} planes of {size}, not "
                             f"{hi - lo}")
        _D_COUNTS["gather_d"] += 1
        most = -(-size // n)
        xd = x.movedim(1, 0)
        if hi - lo < most:    # every rank sends the same length
            xd = torch.cat([xd, xd.new_zeros((most - (hi - lo),
                                              *xd.shape[1:]))])
        parts = _gather_model(xd, mesh).unflatten(0, (n, most))
        full = torch.cat([parts[j, :b - a] for j, (a, b) in
                          enumerate(d_bounds(size, n))])
        return full.movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        _D_COUNTS["gather_d_backward"] += 1
        # a copy: autograd may hand the same gradient to other branches
        total = grad.to(collective_device(), copy=True,
                        memory_format=torch.contiguous_format)
        _all_reduce(total, group=mesh.model_group)
        lo, hi = d_planes(ctx.size, mesh)
        return total[:, lo:hi].to(grad.device).contiguous(), None, None


def gather_d(x, mesh, size):
    """The whole D (``size`` planes) on every rank of the model group,
    from each rank's planes; ``x`` outside a D split."""
    if not _splits(mesh):
        return x
    return _GatherD.apply(x, mesh, size)


class _ShardD(torch.autograd.Function):
    """[B, D, ...] whole -> this rank's planes with ``width`` more on each
    side (zeros past the ends of D). Backward: zero-padded back to D, on
    this rank alone (each rank's copy of the whole is its own)."""

    @staticmethod
    def forward(ctx, x, mesh, width):
        size = x.shape[1]
        lo, hi = d_planes(size, mesh)
        ctx.size, ctx.lo, ctx.hi, ctx.width = size, lo, hi, width
        a, b = max(lo - width, 0), min(hi + width, size)
        out = x.new_zeros((x.shape[0], hi - lo + 2 * width, *x.shape[2:]))
        out[:, a - (lo - width):b - (lo - width)] = x[:, a:b]
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi, width, size = ctx.lo, ctx.hi, ctx.width, ctx.size
        a, b = max(lo - width, 0), min(hi + width, size)
        gx = grad.new_zeros((grad.shape[0], size, *grad.shape[2:]))
        gx[:, a:b] = grad[:, a - (lo - width):b - (lo - width)]
        return gx, None, None


def shard_d(x, mesh, width=0):
    """This rank's planes of a whole D, with ``width`` planes of halo on
    each side taken from the whole (no communication); ``x`` outside a D
    split."""
    if not _splits(mesh):
        return x
    return _ShardD.apply(x, mesh, width)
