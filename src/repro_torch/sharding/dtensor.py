"""DTensor helpers of the model code under a mesh.

Off a mesh every helper hands plain tensors through untouched, so the
model code calls them unconditionally. ``constrain`` is the counterpart of
``jax.lax.with_sharding_constraint``; ``like`` lets a plain tensor made
inside a block (rope's angles, a mask, a zero carry — the same on every
rank) join DTensor arithmetic as a replicated DTensor; ``on_local`` runs a
function on the local blocks of its DTensor arguments under ``local_map``,
for work that DTensor's sharding propagation cannot split by itself (a
loop over time, a gather/scatter routing, a CUDA kernel); ``gathered``
makes a parameter split over the data axes (FSDP) whole there before use.
``zeros`` makes a
DTensor from each rank's block alone, and ``write_`` writes into a
DTensor's own blocks in place (a decode cache). Inside ``on_local``,
``gather_last`` and ``group_blocks`` exchange local blocks over one mesh
dim's process group with autograd (functional collectives: a gather's
backward is a reduce-scatter), skipped where that dim has one rank.
"""

from __future__ import annotations

import torch


def is_dtensor(t) -> bool:
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def constrain(x, layout):
    """``x`` redistributed to ``layout`` (anything with ``mesh`` and
    ``placements``); ``x`` itself when either is not sharded."""
    if layout is None or not is_dtensor(x):
        return x
    return x.redistribute(layout.mesh, layout.placements)


def like(t, ref):
    """``t``, a plain tensor equal on every rank, as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor (else ``t`` itself)."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, ref.device_mesh, replicate(ref),
                              run_check=False)


def replicate(t) -> tuple | None:
    """Placements that replicate over the whole mesh of DTensor ``t``
    (None for a plain tensor)."""
    if not is_dtensor(t):
        return None
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * t.device_mesh.ndim


def gathered(t):
    """``t`` with every split over a data axis ("pod", "data") made whole —
    FSDP's gather of a parameter before it is used, so that the work it
    takes part in stays split as its other dims are (``t`` itself when
    nothing is to gather, or for a plain tensor)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names or ()
    want = tuple(Replicate() if p.is_shard() and names[i] in ("pod", "data")
                 else p for i, p in enumerate(t.placements))
    if want == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def keep_dims(t, dims: tuple[int, ...]) -> tuple | None:
    """``t``'s placements with every split of a dim outside ``dims``, and
    every pending sum (``Partial``), replaced by a whole copy (None for a
    plain tensor)."""
    if not is_dtensor(t):
        return None
    from torch.distributed.tensor import Replicate
    ndim = t.ndim
    return tuple(p if p.is_shard() and p.dim % ndim in dims else Replicate()
                 for p in t.placements)


def model_axis(t) -> tuple[int, int, int] | None:
    """(mesh dim, its size, this rank's index along it) of the ``model``
    axis of DTensor ``t``'s mesh; None for a plain tensor or a mesh
    without one."""
    if not is_dtensor(t):
        return None
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    i = names.index("model")
    return i, mesh.size(i), mesh.get_local_rank(i)


def placed(placements: tuple, i: int, p) -> tuple:
    """``placements`` with mesh dim ``i``'s entry replaced by ``p``."""
    return tuple(p if j == i else q for j, q in enumerate(placements))


def mapped(placements: tuple | None, dims: dict, shape=None
           ) -> tuple | None:
    """``placements`` of one tensor carried to another, of ``shape``, whose
    dim ``dims[d]`` is this one's dim ``d``: each split of a dim in
    ``dims`` moves to its counterpart, every other split (and pending sum)
    becomes a whole copy — as does a split of a counterpart of size 1
    (only a mesh dim of size 1 splits one; DTensor cannot view such a dim
    away)."""
    if placements is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 and (shape is None or shape[dims[p.dim]] > 1)
                 else Replicate() for p in placements)


def summed_over(placements: tuple) -> tuple:
    """The grad layout of a whole copy used against blocks split as
    ``placements``: a pending sum over each mesh dim that splits them."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if p.is_shard() else Replicate()
                 for p in placements)


def on_local(fn, tensors, in_placements, out_placements,
             grad_placements=None):
    """``fn(*tensors)``; when ``tensors`` are DTensors, each is first
    redistributed to its ``in_placements`` entry and ``fn`` runs on the
    local blocks under ``local_map``, its output(s) laid out by
    ``out_placements`` (one placements tuple, or one per output).
    ``grad_placements`` (one per tensor, default ``in_placements``) lays
    out each input's grad: a whole copy (``Replicate``) that meets split
    blocks gets only their share of its grad on each rank, which is
    ``summed_over`` the splits."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors)
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if isinstance(out_placements[0], Placement):      # one output
        out_placements = (out_placements,)
    mesh = tensors[0].device_mesh
    tensors = [t.redistribute(mesh, p)
               for t, p in zip(tensors, in_placements)]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=None if grad_placements is None
                     else tuple(grad_placements),
                     device_mesh=mesh)(*tensors)


def pointwise(fn, t):
    """Elementwise ``fn(t)`` for an op whose backward has no DTensor
    strategy (``log_sigmoid``): a DTensor's local blocks are mapped as
    they lie, any pending sum made whole first."""
    layout = keep_dims(t, tuple(range(t.ndim)))
    return on_local(fn, (t,), (layout,), layout)


def zeros(shape, dtype, device, layout=None):
    """``torch.zeros(shape)``, or with ``layout`` (anything with ``mesh``
    and ``placements``; even splits) a DTensor of it for which each rank
    allocates only its own block."""
    if layout is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    mesh, placements = layout.mesh, tuple(layout.placements)
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            if local[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over mesh dim {i}")
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, placements, run_check=False)


def write_(dst, src) -> None:
    """``dst.copy_(src)``. For a DTensor ``dst`` the copy runs on its local
    blocks at its OWN placements (``src`` redistributed to them first), so
    it lands in ``dst``'s storage: passed at any other placements,
    ``on_local`` would write into a redistributed temporary."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    own = tuple(dst.placements)
    on_local(lambda d, s: d.copy_(s), (dst, like(src, dst)), (own, own),
             own)


def axis_group(t, i: int | None):
    """The process group of mesh dim ``i`` of DTensor ``t``'s mesh, or None
    where there is none or it has one rank (nothing to exchange)."""
    if i is None or not is_dtensor(t) or t.device_mesh.size(i) == 1:
        return None
    return t.device_mesh.get_group(i)


def gather_last(t, group, n: int):
    """``t`` (..., c), one block on each of the ``n`` ranks of ``group``,
    -> (..., n·c): the blocks side by side in rank order, on every rank.
    Its backward reduce-scatters the grad, each rank's share of the sum
    over the ranks. ``t`` itself where ``group`` is None."""
    if group is None:
        return t
    import torch.distributed._functional_collectives as fc
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd
    out = gather(t.contiguous(), 0, group)           # (n·lead, ...)
    return torch.cat(out.chunk(n, dim=0), dim=-1)


def group_blocks(t, group, n: int, g: int, r: int):
    """``t`` (..., c) on rank ``r`` of the ``n`` ranks of ``group`` -> (...,
    g·c): the blocks of the ``g`` ranks of r's run [r - r % g, r - r % g +
    g), side by side in rank order — an all-gather within each run, as one
    all-to-all over the group in which a rank sends its block to the
    ranks of its run and nothing to the rest. Backward the same, the
    grads of a block summed at its rank. ``t`` itself where ``g`` is 1."""
    if g == 1:
        return t
    import torch.distributed._functional_collectives as fc
    first = r - r % g
    sizes = [int(first <= j < first + g) for j in range(n)]
    sent = t.unsqueeze(0).expand(g, *t.shape).contiguous()
    out = fc.all_to_all_single_autograd(sent, sizes, sizes, group)
    return torch.cat(out.unbind(0), dim=-1)
