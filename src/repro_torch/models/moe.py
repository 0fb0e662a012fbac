"""Mixture-of-Experts layer (OLMoE / DeepSeek-V2 style), single device.

Counterpart of the JAX package's ``models/moe.py`` local path
(``_route``, ``_dispatch_compute``, ``_apply_moe_local``): top-k routing
with a Switch aux loss, capacity-bounded dispatch and optional shared
experts; and the reference's expert-sharded dispatch,
:func:`apply_moe_sharded`.

Under tensor parallelism (:mod:`repro_torch.models.tp`: a model placed on
a mesh whose ``model`` axis is above 1, its experts split over it)
:func:`apply_moe` runs the expert-parallel dispatch: every model rank
routes all of its data rank's tokens (the router is replicated, so the
routing agrees), dispatches to its ``n_experts / model`` experts at
``expert_offset = rank * e_local`` (:func:`dispatch_compute` writes no
assignment of another rank's experts, so the shards sum to the single
device's dispatch: the port has no C8), adds its part of the shared
experts and sums over the model group.  The gate values' gradient is
summed over the group ("f"), so the router's is whole on every rank, and
the aux loss, computed alike on every rank, counts once.

Under :func:`data_parallel` (the elastic trainer's step at a width above
1) each rank holds its contiguous block of the global batch's tokens, and
:func:`apply_moe` routes them as the global batch's: every rank's count of
assignments to each expert is gathered, the capacity is the global token
count's, an assignment's position counts the assignments of the ranks
before it, and the aux loss reads the global ``frac``, so the ranks'
outputs are the global step's rows and the mean of their aux losses (and
of its gradients) the global one.

Capacity: ``C = max(ceil(T * k / E * capacity_factor), k)``.  The (token,
slot) assignments are taken in the reference's order, token-major and
slot by slot within a token; an assignment's position within its expert is
the count of earlier assignments to that expert, and those at ``C`` or
past it are dropped (their share falls back to the shared experts / the
residual).  In decode every serving slot is a token, idle ones too, so
idle slots take capacity, as in the reference.

The expert products are plain batched matmuls (``torch.bmm``), as the
reference runs them outside any kernel.  The combine gathers each token's
k expert rows back and sums them in slot order, so the sum's float order
is the same on the card as on the CPU (no atomics).
"""
from __future__ import annotations

import contextlib
import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from . import tp
from .layers import MLP, _empty, mlp_partial


class MoE(nn.Module):
    """``router`` (d, E) f32; experts stacked: ``w1`` / ``w3`` (E, d, ff),
    ``w2`` (E, ff, d); ``shared`` an :class:`MLP` of ``ff * n_shared``
    when ``n_shared > 0``."""

    def __init__(self, d_model: int, moe_d_ff: int, n_experts: int,
                 n_shared: int, act: str, device=None, dtype=torch.float32):
        super().__init__()
        self.router = _empty(d_model, n_experts, device=device,
                             dtype=torch.float32)
        self.w1 = _empty(n_experts, d_model, moe_d_ff, device=device,
                         dtype=dtype)
        self.w3 = _empty(n_experts, d_model, moe_d_ff, device=device,
                         dtype=dtype)
        self.w2 = _empty(n_experts, moe_d_ff, d_model, device=device,
                         dtype=dtype)
        if n_shared > 0:
            self.shared = MLP(d_model, moe_d_ff * n_shared, act, device,
                              dtype)


def gates(xf, router, top_k: int):
    """Router probabilities (T, E) f32 and each token's top-k gate values
    (T, k) f32 and indices (T, k) int64.

    The router product reads xf in its own dtype and accumulates in f32;
    ``torch.topk`` gives the largest probabilities first, as
    ``jax.lax.top_k``."""
    logits = xf.float() @ router.to(xf.dtype).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def route(xf, router, n_experts: int, top_k: int, router_aux_weight: float):
    """Token routing and the Switch aux loss.  xf: (T, d) -> gate values
    (T, k) f32, gate indices (T, k) int64, aux (scalar f32)."""
    probs, gate_vals, gate_idx = gates(xf, router, top_k)
    onehot_any = F.one_hot(gate_idx, n_experts).float()
    frac = onehot_any.sum(dim=1).mean(dim=0)                  # (E,)
    aux = router_aux_weight * n_experts * torch.sum(frac * probs.mean(dim=0))
    return gate_vals, gate_idx, aux


# the data-parallel group whose ranks' tokens route as one batch (None:
# this rank's tokens are the batch); a module global, not a context
# variable, so the autograd thread that recomputes a checkpointed layer in
# the backward sees it too
_DP_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Within it, :func:`apply_moe` routes this rank's tokens as its block
    of the global batch of ``group``'s ranks (rank order = block order);
    a group of one rank, or None, changes nothing."""
    global _DP_GROUP
    import torch.distributed as dist
    prev = _DP_GROUP
    _DP_GROUP = (group if group is not None
                 and dist.get_world_size(group) > 1 else None)
    try:
        yield
    finally:
        _DP_GROUP = prev


def gather_counts(gate_idx, n_experts: int, group):
    """(W, E) int32: each rank of ``group``'s count of assignments to each
    expert, in rank order."""
    import torch.distributed as dist
    counts = F.one_hot(gate_idx.reshape(-1), n_experts).sum(dim=0).to(
        torch.int32)
    out = [torch.empty_like(counts)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, counts, group=group)
    return torch.stack(out)


def capacity_for(tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    return max(int(math.ceil(tokens * top_k / n_experts * capacity_factor)),
               top_k)


def dispatch_plan(gate_idx, *, e_local: int, expert_offset: int,
                  capacity: int, limit=None):
    """Where each (token, slot) assignment goes: ``(expert, position,
    keep)``, each of shape (T * k,) in token-major order.  ``expert`` is in
    local coordinates (0 where the assignment is not local), ``position``
    its index among the assignments to that expert (-1 if not local), and
    ``keep`` whether it is local and within ``capacity`` (and below its
    expert's entry of ``limit``, (e_local,), when given)."""
    flat_e = gate_idx.reshape(-1) - expert_offset
    local = (flat_e >= 0) & (flat_e < e_local)
    flat_e = torch.where(local, flat_e, 0)
    onehot = F.one_hot(flat_e, e_local).to(torch.int32) * local[:, None].to(
        torch.int32)
    # torch sums int32 into int64: cast back, as the reference's int32
    pos = (torch.cumsum(onehot, dim=0).to(torch.int32) * onehot)
    pos_in_e = pos.sum(dim=-1).to(torch.int32) - 1
    keep = local & (pos_in_e >= 0) & (pos_in_e < capacity)
    if limit is not None:
        keep = keep & (pos_in_e < limit[flat_e])
    return flat_e, pos_in_e, keep


def dispatch_compute(p: MoE, xf, gate_vals, gate_idx, *, e_local: int,
                     expert_offset: int, capacity: int, act: str, dtype,
                     limit=None):
    """Gather each local expert's tokens, run the expert MLPs, and combine.

    xf: (T, d); ``gate_idx`` holds global expert ids; this holder's
    ``w1 w2 w3`` are experts ``[expert_offset, expert_offset + e_local)``.
    Returns the (T, d) output of those experts in ``dtype``; ``limit``
    (e_local,) also drops an assignment at or past its expert's entry
    (:func:`dispatch_plan`).  Assignments
    that are not kept are written into a spare last column of the tables,
    which is cut off (the reference's scatter drops them), so nothing here
    waits on the card for a count."""
    t, d = xf.shape
    top_k = gate_idx.shape[-1]
    flat_e, pos_in_e, keep = dispatch_plan(
        gate_idx, e_local=e_local, expert_offset=expert_offset,
        capacity=capacity, limit=limit)
    tok_ids = torch.arange(t, device=xf.device).repeat_interleave(top_k)
    col = torch.where(keep, pos_in_e, capacity).long()
    idx_table = torch.full((e_local, capacity + 1), t, dtype=torch.long,
                           device=xf.device)
    idx_table[flat_e, col] = tok_ids
    gate_table = torch.zeros((e_local, capacity + 1), dtype=torch.float32,
                             device=xf.device)
    gate_table[flat_e, col] = gate_vals.reshape(-1).float()
    idx_table, gate_table = idx_table[:, :capacity], gate_table[:, :capacity]

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    g = xpad[idx_table].to(dtype)                             # (E, C, d)
    h = torch.bmm(g, p.w1.to(dtype))
    h = F.silu(h) if act == "swiglu" else F.gelu(h, approximate="tanh")
    if act in ("swiglu", "geglu"):
        h = h * torch.bmm(g, p.w3.to(dtype))
    y = torch.bmm(h, p.w2.to(dtype))
    y = y * gate_table[..., None].to(dtype)

    # each assignment's row of y (a zero row when dropped), summed per
    # token in slot order
    rows = torch.where(keep, flat_e * capacity + pos_in_e, e_local * capacity)
    ypad = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))], dim=0)
    parts = ypad[rows.long()].reshape(t, top_k, d)
    out = parts[:, 0]
    for j in range(1, top_k):
        out = out + parts[:, j]
    return out


def apply_moe(p: MoE, x, *, n_experts: int, top_k: int, act: str, dtype,
              capacity_factor: float = 1.25,
              router_aux_weight: float = 0.01):
    """x: (B, S, d) -> ``(out (B, S, d), aux)``: the routed experts' output
    plus the shared experts', and the load-balancing loss that training
    adds (serving drops it)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    group, limit = _DP_GROUP, None
    if group is None:
        gate_vals, gate_idx, aux = route(xf, p.router, n_experts, top_k,
                                         router_aux_weight)
        capacity = capacity_for(t, n_experts, top_k, capacity_factor)
    else:
        # this rank's tokens as its block of the global batch's: the global
        # frac in the aux loss (its gradient this rank's share), the global
        # capacity, and each expert's room left after the ranks before
        import torch.distributed as dist
        probs, gate_vals, gate_idx = gates(xf, p.router, top_k)
        counts = gather_counts(gate_idx, n_experts, group)
        t_all = t * counts.shape[0]
        frac = counts.sum(dim=0).float() / t_all
        aux = router_aux_weight * n_experts * torch.sum(
            frac * probs.mean(dim=0))
        cap_all = capacity_for(t_all, n_experts, top_k, capacity_factor)
        limit = cap_all - counts[:dist.get_rank(group)].sum(dim=0)
        capacity = min(cap_all, t)
    grp = tp.active()
    if grp is not None and tp.moe_mode(n_experts, grp.size) == "experts":
        return _expert_parallel(p, x, gate_vals, gate_idx, aux, grp,
                                n_experts=n_experts, capacity=capacity,
                                act=act, dtype=dtype, limit=limit)
    out = dispatch_compute(p, xf, gate_vals, gate_idx, e_local=n_experts,
                           expert_offset=0, capacity=capacity, act=act,
                           dtype=dtype, limit=limit)
    out = out.reshape(b, s, d)
    if hasattr(p, "shared"):
        out = out + mlp_partial(p.shared, x, act, dtype)
    return out, aux


def _expert_parallel(p: MoE, x, gate_vals, gate_idx, aux, grp, *,
                     n_experts: int, capacity: int, act: str, dtype,
                     limit=None):
    """This rank's experts' share of the routed output, summed over the
    model group, then the shared experts (whole on every rank: their
    stacked ``(L, d, ff)`` leaves read as experts by the rules, a layer's
    row is replicated, :mod:`repro_torch.models.sharding`)."""
    b, s, d = x.shape
    e_local = n_experts // grp.size
    offset = grp.rank * e_local
    if limit is not None:
        limit = limit[offset:offset + e_local]
    xs = tp.copy_to(x)
    experts = types.SimpleNamespace(w1=tp.local(p.w1), w3=tp.local(p.w3),
                                    w2=tp.local(p.w2))
    out = dispatch_compute(experts, xs.reshape(b * s, d),
                           tp.copy_to(gate_vals), gate_idx, e_local=e_local,
                           expert_offset=offset, capacity=capacity, act=act,
                           dtype=dtype, limit=limit).reshape(b, s, d)
    out = tp.reduce_from(out)
    if hasattr(p, "shared"):
        out = out + mlp_partial(p.shared, x, act, dtype)
    return out, aux


def _block(t, mesh, want):
    """This rank's block of ``t`` with dimension ``d`` split over the mesh
    axis ``want[d]`` (in equal contiguous pieces, by the rank's
    coordinate): a ``DTensor`` placed on ``mesh`` keeps the splits it has
    and takes the others from its local shard; a plain tensor takes them
    all."""
    from torch.distributed.tensor import DTensor
    names = tuple(mesh.mesh_dim_names)
    have = {}
    loc = t
    if isinstance(t, DTensor):
        loc = t.to_local()
        for i, place in enumerate(t.placements):
            if place.is_shard() and mesh.mesh.shape[i] > 1:
                have[place.dim] = names[i]
    for dim, axis in have.items():
        if want.get(dim) != axis:
            raise ValueError(f"a {tuple(t.shape)} weight split on dim {dim} "
                             f"over {axis!r}, the layout wants {want}")
    for dim, axis in want.items():
        if axis not in names or dim in have:
            continue
        n = mesh.mesh.shape[names.index(axis)]
        loc = torch.chunk(loc, n, dim=dim)[mesh.get_local_rank(axis)]
    return loc


def apply_moe_sharded(p: MoE, x, *, mesh, n_experts: int, top_k: int,
                      act: str, dtype, capacity_factor: float = 1.25,
                      router_aux_weight: float = 0.01):
    """The reference's expert-sharded dispatch on a ``(data, model)``
    ``DeviceMesh``: experts over ``model``.  Every rank of the mesh calls it
    with the whole batch x (B, S, d); ``p``'s weights are whole, or placed
    on ``mesh`` by :func:`repro_torch.elastic.resharding.reshard_tree`.
    Returns ``(out (B, S, d), aux)`` on every rank.

    Two layouts, as the reference's:

    * train / prefill (S > 1): the batch split over ``data`` where it
      divides, each data rank's tokens routed as their block of the whole
      batch (:func:`data_parallel`: the whole batch's capacity and aux
      loss, so the result is :func:`apply_moe`'s on one device; the
      reference gives each shard a capacity of its own), each model rank
      its experts, the sum over ``model``, the rows gathered over
      ``data``;
    * decode (S == 1, ``ff`` divisible by ``data``): every rank routes all
      tokens; its experts (over ``model``) at its slice of ``ff`` (over
      ``data``), the shared experts' partial divided by the data size, and
      one sum over the mesh.
    """
    names = tuple(mesh.mesh_dim_names)
    if "pod" in names:
        raise ValueError("apply_moe_sharded takes a (data, model) mesh; a "
                         "pod axis is not supported")
    sizes = dict(zip(names, mesh.mesh.shape))
    n_model, dp = sizes.get("model", 1), sizes.get("data", 1)
    b, s, d = x.shape
    ff = p.w1.shape[-1]
    if n_experts % n_model:
        raise ValueError(f"{n_experts} experts do not split over {n_model} "
                         "model ranks")
    model_grp = tp.group_of_mesh(mesh)
    if s == 1 and dp > 1 and ff % dp == 0 and ff >= dp:
        e_local = n_experts // n_model
        offset = (model_grp.rank if model_grp else 0) * e_local
        experts = {"w1": {0: "model", 2: "data"},
                   "w3": {0: "model", 2: "data"},
                   "w2": {0: "model", 1: "data"}}
        local = types.SimpleNamespace(**{
            k: _block(getattr(p, k), mesh, want)
            for k, want in experts.items()})
        xf = x.reshape(b * s, d)
        gate_vals, gate_idx, aux = route(xf, p.router, n_experts, top_k,
                                         router_aux_weight)
        capacity = capacity_for(b * s, n_experts, top_k, capacity_factor)
        out = dispatch_compute(local, xf, gate_vals, gate_idx,
                               e_local=e_local, expert_offset=offset,
                               capacity=capacity, act=act,
                               dtype=dtype).reshape(b, s, d)
        if hasattr(p, "shared"):
            cols = {"w1": {1: "model"}, "w3": {1: "model"},
                    "w2": {0: "model"}}
            shared = types.SimpleNamespace(**{
                k: _block(getattr(p.shared, k), mesh, want)
                for k, want in cols.items() if hasattr(p.shared, k)})
            # every data rank computes the same partial: counted once
            out = out + mlp_partial(shared, x, act, dtype) / dp
        for axis in ("model", "data"):
            # the partial sums of each axis' ranks added ("g" over it)
            with tp.model_parallel(tp.group_of_mesh(mesh, axis)):
                out = tp.reduce_from(out)
        return out, aux
    split = dp > 1 and b % dp == 0
    rows = b // dp if split else b
    lo = mesh.get_local_rank("data") * rows if split else 0
    data_grp = mesh.get_group("data") if split else None
    view = types.SimpleNamespace(router=p.router, **{
        k: _block(getattr(p, k), mesh, {0: "model"})
        for k in ("w1", "w3", "w2")})
    if hasattr(p, "shared"):
        view.shared = p.shared
    with data_parallel(data_grp), tp.model_parallel(model_grp):
        out, aux = apply_moe(view, x[lo:lo + rows], n_experts=n_experts,
                             top_k=top_k, act=act, dtype=dtype,
                             capacity_factor=capacity_factor,
                             router_aux_weight=router_aux_weight)
    if split:
        # the data ranks' rows joined, their aux losses averaged
        with tp.model_parallel(tp.group_of_mesh(mesh, "data")):
            out = tp.gather(out, 0)
            aux = tp.reduce_from(aux) / dp
    return out, aux
