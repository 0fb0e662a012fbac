"""Tensor parallelism over the ``model`` axis of a ``(data, model)`` mesh.

The reference runs its forward on a mesh by placing the parameters with
``param_specs`` and letting GSPMD insert the collectives.  The port's
kernels take plain tensors, so here each layer computes on its parameters'
*local shards* (``to_local()`` of the ``DTensor`` s that
:func:`repro_torch.elastic.resharding.reshard_tree` places) and crosses the
region boundaries with explicit, autograd-aware collectives over the
mesh's ``model`` group (Megatron-LM's pair, arXiv:1909.08053):

* :func:`copy_to` ("f"): identity forward, all-reduce backward, where a
  replicated activation (or parameter) enters a sharded region;
* :func:`reduce_from` ("g"): all-reduce forward, identity backward, after
  a row-parallel product;
* :func:`gather` / :func:`scatter`: all-gather / take the local slice
  along a dimension, each the other's backward; a gather whose consumers
  are partitioned sums its gradient before slicing (``grad="sum"``).

Where no model group is open each of them is ``x`` itself and
:func:`local` a plain tensor itself, so a layer has one body for one rank
and for many; a block that runs whole on every rank goes through
:func:`on_whole`.

:func:`tensor_parallel` sets the group from a model's own parameters (the
placements decide, as the input shardings do in the reference; read once
a placement) for the length of a forward: a module global, not a context
variable, so the autograd thread that recomputes a checkpointed layer in
the backward sees it and issues the same collectives in the same order on
every rank.

The per-block plan (:func:`tp_plan`, the mode helpers) is computed from
the config and the mesh's model size alone, with the divisibility rules of
:mod:`repro_torch.models.sharding`: a block whose specs split on head
boundaries runs on its local heads; one whose specs split a head gathers
the split weights (``kv_gather``: the kv heads its local q heads need;
``whole``: the block on every rank from gathered weights).

On a gloo group a CUDA tensor crosses through the host (gloo's transport;
two ranks may then share one card), never a fallback: the kernels still
run on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
import weakref
from typing import Dict, FrozenSet, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A mesh's ``model`` process group and this rank's place in it."""

    group: object
    rank: int
    size: int
    host: bool      # gloo: CUDA tensors cross through the host


# the model group of the forward that runs (None: one rank holds the model)
_TP: Optional[ModelGroup] = None


def active() -> Optional[ModelGroup]:
    return _TP


def size() -> int:
    """The model group's size: 1 where one rank holds the model."""
    return _TP.size if _TP is not None else 1


def _model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


_DTENSOR = None


def _is_dtensor(t) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(t, _DTENSOR)


def shard_dim(t) -> Optional[int]:
    """The dimension ``t`` (a ``DTensor``) is split along over its mesh's
    ``model`` axis, or None (a plain tensor, or one replicated over
    ``model``)."""
    if not _is_dtensor(t):
        return None
    dim = _model_dim(t.device_mesh)
    if dim is None or t.device_mesh.mesh.shape[dim] == 1:
        return None
    place = t.placements[dim]
    return place.dim if place.is_shard() else None


def group_of_mesh(mesh, axis: str = "model") -> Optional[ModelGroup]:
    """The group of the ``DeviceMesh`` ``mesh``'s ``axis`` when its size is
    above 1, else None."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names or mesh.mesh.shape[names.index(axis)] == 1:
        return None
    group = mesh.get_group(axis)
    return ModelGroup(group, mesh.get_local_rank(axis),
                      dist.get_world_size(group),
                      dist.get_backend(group) == "gloo")


# each module's (model group, split parameter names), from its parameters'
# placements; placements_changed drops a module's entry
_PLACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _placement(module) -> Tuple[Optional[ModelGroup], FrozenSet[str]]:
    if module not in _PLACED:
        grp, split = None, []
        for name, p in module.named_parameters():
            if shard_dim(p) is not None:
                grp = grp or group_of_mesh(p.device_mesh)
                split.append(name)
        _PLACED[module] = (grp, frozenset(split))
    return _PLACED[module]


def model_group_of(module) -> Optional[ModelGroup]:
    """The ``model`` group of the mesh ``module``'s sharded parameters lie
    on, when its size is above 1; else None.  Read once a placement: see
    :func:`placements_changed`."""
    return _placement(module)[0]


def split_names(module) -> FrozenSet[str]:
    """The names of ``module``'s parameters split over its model group."""
    return _placement(module)[1]


def placements_changed(module) -> None:
    """Forget what :func:`model_group_of` read of ``module``: whatever
    replaces its parameters (``resharding.reshard_tree``) calls it."""
    _PLACED.pop(module, None)


@contextlib.contextmanager
def model_parallel(grp: Optional[ModelGroup]):
    """Within it, the layers run tensor-parallel over ``grp`` (None: on
    one rank)."""
    global _TP
    prev = _TP
    _TP = grp
    try:
        yield grp
    finally:
        _TP = prev


def tensor_parallel(module):
    """:func:`model_parallel` over ``module``'s model group: nothing
    changes for a module with no parameter sharded over a ``model`` axis of
    size > 1."""
    return model_parallel(model_group_of(module))


# ------------------------------------------------------------ collectives
def _all_reduce(x: torch.Tensor, grp: ModelGroup) -> torch.Tensor:
    import torch.distributed as dist
    buf = x.detach().to("cpu" if grp.host else x.device, copy=True)
    dist.all_reduce(buf, group=grp.group)
    return buf.to(x.device)


def _all_gather(x: torch.Tensor, dim: int, grp: ModelGroup) -> torch.Tensor:
    import torch.distributed as dist
    buf = x.detach().contiguous()
    if grp.host:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(grp.size)]
    dist.all_gather(parts, buf, group=grp.group)
    return torch.cat(parts, dim=dim).to(x.device)


def _slice(x: torch.Tensor, dim: int, grp: ModelGroup) -> torch.Tensor:
    return torch.chunk(x, grp.size, dim=dim)[grp.rank].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.grp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grp, summed):
        ctx.dim, ctx.grp, ctx.summed = dim, grp, summed
        return _all_gather(x, dim, grp)

    @staticmethod
    def backward(ctx, dy):
        if ctx.summed:
            dy = _all_reduce(dy, ctx.grp)
        return _slice(dy, ctx.dim, ctx.grp), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grp):
        ctx.dim, ctx.grp = dim, grp
        return _slice(x, dim, grp)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.dim, ctx.grp), None, None


# Each collective is ``x`` itself where no model group is open, so one
# body serves one rank and many.
def copy_to(x: torch.Tensor) -> torch.Tensor:
    """"f": identity forward, the gradient summed over the model group."""
    return x if _TP is None else _CopyTo.apply(x, _TP)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """"g": the partial results summed over the model group; identity
    backward."""
    return x if _TP is None else _ReduceFrom.apply(x, _TP)


def gather(x: torch.Tensor, dim: int, grad: str = "slice") -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``dim`` joined in rank order.  The
    backward takes this rank's slice of the gradient: as it is where every
    rank computes the same thing from the result (``grad="slice"``), after
    summing it over the ranks where each uses its own part
    (``grad="sum"``)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad {grad!r} is not 'slice' or 'sum'")
    if _TP is None:
        return x
    return _Gather.apply(x, dim % x.dim(), _TP, grad == "sum")


def scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``; the backward gathers
    the ranks' gradients."""
    return x if _TP is None else _Scatter.apply(x, dim % x.dim(), _TP)


# ------------------------------------------------------------ parameters
def local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` 's local shard (differentiable: the gradient lands on
    the ``DTensor``), a plain tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def full(t: torch.Tensor, grad: str = "slice") -> torch.Tensor:
    """The whole of a parameter: its shards gathered over the model group
    where it is split (:func:`gather`), else its local tensor; with
    ``grad="sum"`` (each rank uses its own part) the gradient is summed
    over the group in either case."""
    d = shard_dim(t)
    loc = local(t)
    if d is not None:
        return gather(loc, d, grad)
    return copy_to(loc) if grad == "sum" else loc


def whole(module) -> types.SimpleNamespace:
    """``module``'s parameters (and its children's, as attributes of the
    same names) gathered whole, for a block every rank runs in full: the
    gradient of each gathered weight is this rank's slice of the one every
    rank computes."""
    ns = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, full(p))
    for name, child in module.named_children():
        setattr(ns, name, whole(child))
    return ns


def on_whole(fn, module, *args, **kwargs):
    """``fn(whole(module), *args, **kwargs)`` with no model group open: a
    block every rank runs in full, its collectives identities."""
    params = whole(module)
    with model_parallel(None):
        return fn(params, *args, **kwargs)


# ------------------------------------------------------------ the plan
def attn_mode(n_heads: int, n_kv: int, head_dim: int, model: int) -> str:
    """How a GQA (or cross-) attention block runs at ``model`` ranks:
    ``plain`` (one rank), ``heads`` (q and kv heads split on head
    boundaries: each rank its own), ``kv_gather`` (q heads split on their
    boundaries, a kv head split: each rank gathers ``wk`` / ``wv`` and
    computes the kv heads its q heads use) or ``whole`` (a q head split:
    every rank runs the block from gathered weights)."""
    if model == 1:
        return "plain"
    if n_heads % model == 0 and n_kv % model == 0:
        return "heads"
    if n_heads % model == 0:
        return "kv_gather"
    return "whole"


def mlp_mode(d_ff: int, model: int) -> str:
    """``columns`` (``w1`` / ``w3`` column-parallel, ``w2`` row-parallel) or
    ``plain`` (one rank, or ``d_ff`` indivisible: replicated)."""
    return "columns" if model > 1 and d_ff % model == 0 else "plain"


def moe_mode(n_experts: int, model: int) -> str:
    """``experts`` (each rank its ``n_experts / model`` experts) or
    ``plain``."""
    return "experts" if model > 1 and n_experts % model == 0 else "plain"


def ssm_mode(nheads: int, model: int) -> str:
    """A Mamba-2 block: ``heads`` (local SSD heads), ``whole`` (the rules
    split a head or leave the heads whole: every rank runs the block from
    gathered weights) or ``plain``."""
    if model == 1:
        return "plain"
    return "heads" if nheads % model == 0 else "whole"


def vocab_sharded(vocab: int, model: int) -> bool:
    """Whether the embedding table (and the unembedding) is split on
    vocab: a vocab-parallel lookup and logits gathered whole."""
    return model > 1 and vocab % model == 0


def mla_mode(n_heads: int, model: int) -> str:
    """An MLA block: ``heads`` (the latents whole on every rank, their
    norms on the gathered rows; ``wq_b`` / ``wk_b`` / ``wv_b`` on this
    rank's heads), ``whole`` (the heads do not split: every rank runs the
    block from gathered weights) or ``plain``."""
    if model == 1:
        return "plain"
    return "heads" if n_heads % model == 0 else "whole"


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    attn: str = ""    # attn_mode / mla_mode ("" for a Mamba-2 block)
    ffn: str = ""     # mlp_mode or moe_mode
    shared: str = ""  # a MoE block's shared experts: always "plain"
    ssm: str = ""     # ssm_mode
    cross: str = ""   # a dec block's cross-attention: attn_mode


@dataclasses.dataclass(frozen=True)
class TPPlan:
    model: int
    vocab: bool
    blocks: Dict[str, BlockPlan]


def tp_plan(cfg, mesh) -> TPPlan:
    """The plan of ``cfg`` on ``mesh`` (anything with ``axis_names`` and a
    ``shape`` by name, or a ``DeviceMesh``): the mode of each block kind
    its decoder plan (and encoder) runs."""
    from repro_torch.launch.mesh import mesh_view
    from repro_torch.models.transformer import _ssm_dims, decoder_plan

    view = mesh_view(mesh)
    m = view.shape["model"] if "model" in view.axis_names else 1
    kinds = {seg.kind for seg in decoder_plan(cfg)}
    if cfg.is_encdec:
        kinds.add("enc")
    blocks = {}
    for kind in sorted(kinds):
        if kind == "mamba":
            blocks[kind] = BlockPlan(
                ssm=ssm_mode(_ssm_dims(cfg).nheads, m))
            continue
        attn = (mla_mode(cfg.n_heads, m)
                if cfg.attn == "mla" and kind in ("attn", "moe")
                else attn_mode(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, m))
        if kind == "moe":
            # the shared experts' stacked leaves read as experts: a layer's
            # row is replicated (models/sharding.py)
            blocks[kind] = BlockPlan(
                attn=attn, ffn=moe_mode(cfg.n_experts, m),
                shared="plain" if cfg.n_shared_experts else "")
        else:
            blocks[kind] = BlockPlan(
                attn=attn, ffn=mlp_mode(cfg.d_ff, m),
                cross=(attn_mode(cfg.n_heads, cfg.n_heads, cfg.head_dim, m)
                       if kind == "dec" else ""))
    return TPPlan(model=m, vocab=vocab_sharded(cfg.vocab, m), blocks=blocks)
