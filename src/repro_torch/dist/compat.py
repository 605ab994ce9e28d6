"""``shard_map`` over a torch `DeviceMesh`, and the collectives its bodies
call.

The reference's `dist/compat.py` picks ``jax.shard_map`` or its
experimental spelling.  Here `shard_map(f, mesh=, in_specs=, out_specs=)`
runs `f` on each rank's local shards: every DTensor input is brought to
the placements its spec names (`dist.sharding.placements`) and handed to
`f` as its local tensor; every output of `f` is wrapped as a DTensor with
its out spec's placements.  Inside `f`, communication is explicit:
`psum(x, axis)` and the tiled `all_gather(x, axis, dim)` over named mesh
axes, built on ``torch.distributed._functional_collectives``, which
`dist.hlo_analysis.StepCounter` prices with the ring formulas.

Gradients follow the tensor-parallel convention: a value replicated over
an axis carries its whole cotangent on every rank of that axis, unless the
axis is one of `varying` (the mesh axes along which the body's data
differ: the batch axes of a train step).  On a varying axis each rank's
cotangent of a replicated value is its own share and the shares sum to the
whole.  So, for an axis `a`:

* `psum(x, a)`: the backward is `psum` over `a` when `a` varies, else the
  identity (the output's cotangent is already whole);
* `all_gather(x, a, dim)`: the backward is a reduce-scatter over `a` when
  `a` varies, else the rank's own block of the cotangent;
* `enter(x, a)`: the identity, whose backward is `psum` over `a`: what a
  value replicated over `a` passes through before a computation sharded
  over `a` (its cotangent there is a partial sum);
* an input replicated over a varying axis gets a `Partial` cotangent
  (its sum over the axis is the gradient), every other input a cotangent
  with its own placements.

JAX tracks the same distinction in its types (``check_vma``); the port
takes `varying` from the caller instead, and accepts ``check_vma`` only
for the reference's signature.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate

from .sharding import P, placements

_ENV = threading.local()
# the functional collectives' names in this torch (the *_tensor spellings
# are the older ones, deprecated where the *_single ones exist)
_all_gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
_reduce_scatter = (getattr(fc, "reduce_scatter_single", None)
                   or fc.reduce_scatter_tensor)


def _env():
    """(mesh, varying axes) of the innermost `shard_map` body running."""
    env = getattr(_ENV, "stack", None)
    if not env:
        raise RuntimeError("psum / all_gather / enter name a mesh axis: "
                           "call them inside a shard_map body")
    return env[-1]


@contextlib.contextmanager
def _body(mesh, varying):
    stack = _ENV.__dict__.setdefault("stack", [])
    stack.append((mesh, frozenset(varying)))
    try:
        yield
    finally:
        stack.pop()


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(axis) -> int:
    """Ranks along `axis` (a name or a tuple of names) of the current
    body's mesh."""
    mesh, _ = _env()
    n = 1
    for a in _axes(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(axis) -> int:
    """This rank's coordinate along `axis` (a tuple: outer axis first, as
    JAX orders a tuple of axes)."""
    mesh, _ = _env()
    idx = 0
    for a in _axes(axis):
        d = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def _group(mesh, a):
    return (mesh, mesh.mesh_dim_names.index(a))


def _wait(t):
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _all_reduce(x, mesh, axes):
    for a in axes:
        x = _wait(fc.all_reduce(x.contiguous(), "sum", _group(mesh, a)))
    return x


def _gather(x, mesh, axes, dim):
    # inner axis first: a tuple's outer axis holds the major blocks
    for a in reversed(axes):
        x = _wait(_all_gather(x.contiguous(), dim, _group(mesh, a)))
    return x


def _scatter_sum(x, mesh, axes, dim):
    for a in axes:
        x = _wait(_reduce_scatter(x.contiguous(), "sum", dim,
                                  _group(mesh, a)))
    return x


def _own_block(x, mesh, axes, dim):
    for a in axes:
        d = mesh.mesh_dim_names.index(a)
        n = mesh.size(d)
        x = x.narrow(dim, mesh.get_local_rank(d) * (x.shape[dim] // n),
                     x.shape[dim] // n)
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, varying):
        ctx.mesh, ctx.axes = mesh, tuple(a for a in axes if a in varying)
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, varying):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.vary = tuple(a for a in axes if a in varying)
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter over the varying axes, own block over the others
        # (outer axis first, the order the blocks were gathered in)
        for a in ctx.axes:
            g = (_scatter_sum(g, ctx.mesh, (a,), ctx.dim) if a in ctx.vary
                 else _own_block(g, ctx.mesh, (a,), ctx.dim))
        return g, None, None, None, None


def psum(x, axis):
    """Sum of `x` over the mesh axis `axis` (or a tuple of axes)."""
    mesh, varying = _env()
    return _Psum.apply(x, mesh, _axes(axis), varying)


def all_gather(x, axis, dim: int):
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the blocks of
    every rank along `axis`, concatenated on `dim` in rank order."""
    mesh, varying = _env()
    return _AllGather.apply(x, mesh, _axes(axis), dim % x.dim(), varying)


def enter(x, axis):
    """`x` as it is; its cotangent is summed over `axis` in the backward
    (a replicated value entering a computation sharded over `axis`)."""
    mesh, _ = _env()
    return _Enter.apply(x, mesh, _axes(axis))


# ---------------------------------------------------------------------------
# the shim
# ---------------------------------------------------------------------------


def _map2(fn, tree, specs):
    """`fn(leaf, spec)` over a pytree of dicts / lists / tuples, `specs`
    either a parallel tree or one spec for the whole subtree."""
    if isinstance(specs, P) or specs is None:
        if isinstance(tree, dict):
            return {k: _map2(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map2(fn, v, specs) for v in tree)
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"spec tree {specs!r} does not match {type(tree)}")


def local_block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of a whole (unsharded) tensor under `spec`."""
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = 1
        idx = 0
        for a in _axes(entry):
            md = names.index(a)
            n *= mesh.size(md)
            idx = idx * mesh.size(md) + mesh.get_local_rank(md)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{n} ways ({spec})")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def to_dtensor(x: torch.Tensor, mesh, spec) -> DTensor:
    """A whole tensor held alike on every rank, placed under `spec`: each
    rank keeps a copy of its own block (no communication; the copy, so that
    a step updating the DTensor in place leaves `x` alone)."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(mesh, spec))
    block = local_block(x, mesh, spec).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(block, mesh,
                              placements(mesh, spec), run_check=False,
                              shape=x.shape, stride=x.stride()
                              if x.is_contiguous() else None)


def like(dt: DTensor, local: torch.Tensor) -> DTensor:
    """`local` as the local block of a DTensor placed as `dt` is (made
    from local tensors, so a counter sees local work only)."""
    return DTensor.from_local(local, dt.device_mesh, dt.placements,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def _grad_placements(mesh, pl, varying):
    names = mesh.mesh_dim_names
    return tuple(Partial() if isinstance(p, Replicate) and names[d] in varying
                 else p for d, p in enumerate(pl))


def _in(x, spec, mesh, varying):
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    pl = placements(mesh, spec)
    if not isinstance(x, DTensor):
        return local_block(x, mesh, spec)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return x.to_local(grad_placements=_grad_placements(mesh, pl, varying))


def _out(y, spec, mesh):
    if spec is None or not isinstance(y, torch.Tensor):
        return y
    return DTensor.from_local(y, mesh, placements(mesh, spec),
                              run_check=False)


def shard_map(f, *, mesh, in_specs, out_specs, check_vma=None,
              varying=()):
    """`f` on local shards: ``shard_map(f, ...)(*args)`` hands `f` each
    argument's local tensor under `in_specs` (a DTensor is redistributed
    there first; a plain tensor is taken as the whole array, of which each
    rank keeps its block) and wraps `f`'s outputs as DTensors under
    `out_specs`.  `in_specs` is a tuple, one spec (tree) an argument; a
    spec of None passes a leaf through as it is.  See the
    module docstring for `varying`."""
    del check_vma

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             f"in_specs")
        local = [_map2(lambda x, s: _in(x, s, mesh, varying), a, s)
                 for a, s in zip(args, in_specs)]
        with _body(mesh, varying):
            out = f(*local)
        return _map2(lambda y, s: _out(y, s, mesh), out, out_specs)

    return wrapped
