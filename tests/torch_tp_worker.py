"""Worker processes of the port's tensor-parallel tests: each rank of a gloo
world of CPU processes (:mod:`torch_dp_worker`'s ``run``) runs one world's
cases and returns its figures.  Imports no JAX: the parent test builds the
JAX side and passes its parameters in as numpy arrays."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_dp_worker as W

# (arch, config overrides) of the forward cases; MoE configs take the
# reference test's capacity factor (tests/test_distribution.py)
MOE_CAPACITY = 64.0
SEQ, BATCH = 16, 8


def config(arch: str, over=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=MOE_CAPACITY)
    return cfg


def _model(cfg, flat):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.transformer import init_params
    if flat is not None:
        return lm_params_from_numpy(flat, cfg, "cpu")
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg, seed_step=1):
    from repro_torch.convert import to_tensors
    from repro_torch.train.data import batch_for
    return to_tensors(batch_for(cfg, SEQ, BATCH, step=seed_step), "cpu")


def forward_case(mesh, cfg, flat=None):
    """The port's single-device logits and its tensor-parallel logits on
    ``mesh`` from the same parameters (f32)."""
    from repro_torch.elastic.resharding import reshard_tree
    from repro_torch.models.tp import model_group_of
    from repro_torch.models.transformer import forward_logits
    model = _model(cfg, flat)
    batch = _batch(cfg)
    ref = forward_logits(model, cfg, batch, dtype=torch.float32)
    reshard_tree({"params": model}, mesh)
    grp = model_group_of(model)
    got = forward_logits(model, cfg, batch, dtype=torch.float32)
    return {"err": float((got - ref).abs().max()), "logits": got.numpy(),
            "model_ranks": grp.size if grp else 1}


def gradient_case(mesh, cfg, remat="dots"):
    """Loss and every gradient (gathered whole) of one ``forward_train``
    on one rank and tensor-parallel on ``mesh``: their differences."""
    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.elastic.resharding import reshard_tree
    from repro_torch.models.transformer import forward_train
    out = []
    for placed in (False, True):
        model = _model(cfg, None)
        model.requires_grad_(True)
        if placed:
            reshard_tree({"params": model}, mesh)
        loss, _ = forward_train(model, cfg, _batch(cfg, 2),
                                dtype=torch.float32, remat=remat)
        loss.backward()
        out.append((float(loss.detach()),
                    lm_params_to_numpy(model, cfg, grad=True)))
    (l0, g0), (l1, g1) = out
    rel = {k: float(np.abs(g1[k] - g0[k]).max()
                    / max(float(np.abs(g0[k]).max()), 1e-30)) for k in g0}
    return {"loss": (l0, l1), "grad_rel": rel}


def moe_case(mesh, flat, x, seq_one: bool):
    """``apply_moe_sharded`` on ``mesh`` of the reduced olmoe's MoE layer
    (the reference's weights ``flat``) over the whole batch ``x``."""
    from repro_torch.convert import module_from_numpy
    from repro_torch.models.moe import MoE, apply_moe_sharded
    cfg = config("olmoe-1b-7b")
    p = module_from_numpy(MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                              cfg.n_shared_experts, cfg.act, "cpu"), flat)
    xt = torch.from_numpy(np.array(x, copy=True))
    if seq_one:
        xt = xt[:, :1]
    out, aux = apply_moe_sharded(
        p, xt, mesh=mesh, n_experts=cfg.n_experts, top_k=cfg.top_k,
        act=cfg.act, dtype=torch.float32,
        capacity_factor=cfg.moe_capacity_factor)
    return {"out": out.detach().numpy(), "aux": float(aux)}


def model_2_world(rank: int, jax_flats, moe_flat, moe_x, fwd_cases,
                  grad_cases):
    """A world of 2 ranks as a (1, 2) mesh: each forward case, the
    gradient cases, and the MoE layer's train / prefill layout."""
    from repro_torch.elastic.resharding import make_job_mesh
    mesh = make_job_mesh(1, 2)
    out = {"forward": {}, "grads": {}}
    for name, (arch, over) in fwd_cases.items():
        res = forward_case(mesh, config(arch, over), jax_flats.get(name))
        if rank != 0:
            res.pop("logits")
        out["forward"][name] = res
    for name, (arch, over, remat) in grad_cases.items():
        out["grads"][name] = gradient_case(mesh, config(arch, over), remat)
    out["moe"] = moe_case(mesh, moe_flat, moe_x, seq_one=False)
    return out


def model_4_world(rank: int, fwd_cases, grad_cases):
    """A world of 4 ranks as a (1, 4) mesh: heads split mid-head."""
    from repro_torch.elastic.resharding import make_job_mesh
    mesh = make_job_mesh(1, 4)
    out = {"forward": {}, "grads": {}}
    for name, (arch, over) in fwd_cases.items():
        res = forward_case(mesh, config(arch, over))
        res.pop("logits")
        out["forward"][name] = res
    for name, (arch, over, remat) in grad_cases.items():
        out["grads"][name] = gradient_case(mesh, config(arch, over), remat)
    return out


def _trainer(arch: str, width: int, model_parallel: int, ckpt_dir=None):
    from repro_torch.elastic.manager import ElasticTrainer
    return ElasticTrainer(W.elastic_config(arch), W.train_config(),
                          global_batch=4, seq_len=16, width=width,
                          model_parallel=model_parallel, ckpt_dir=ckpt_dir,
                          ckpt_every=100, seed=0, device="cpu")


def _host(state):
    """The train state as numpy arrays of their own (a CPU leaf's array
    from ``train_state_to_numpy`` shares the tensor's memory, which the
    steps after it write)."""
    from repro_torch.convert import train_state_to_numpy

    def own(tree):
        return ({k: own(v) for k, v in tree.items()}
                if isinstance(tree, dict) else np.array(tree, copy=True))
    return own(train_state_to_numpy(state))


def tp_schedule(rank: int, arch: str, ckpt_dir: str):
    """A trainer at model 2 through :data:`torch_dp_worker.RESIZE_SCHEDULE`
    (widths 1 -> 2 -> 1: meshes (1, 2), (2, 2), (1, 2)) beside a width-1,
    model-1 trainer of the same seed; then a checkpoint, a fresh model-2
    trainer's resume from it and a failure restore at width 1."""
    from repro_torch.elastic.resharding import in_mesh
    n = sum(a for kind, a in W.RESIZE_SCHEDULE if kind == "step")
    ref = _trainer(arch, 1, 1)
    ref_stats = [ref.step() for _ in range(n)]
    ref_state = _host(ref.state) if rank == 0 else None
    tr = _trainer(arch, 1, 2, ckpt_dir)
    stats, meshes = [], []
    for action, arg in W.RESIZE_SCHEDULE:
        if action == "step":
            for _ in range(arg):
                meshes.append(tuple(tr.mesh.mesh.shape))
                stats.append(tr.step())
        else:
            tr.resize(arg)
    path = tr.checkpoint()
    state = _host(tr.state) if in_mesh(tr.mesh) else None
    fresh = _trainer(arch, 1, 2, ckpt_dir)
    resumed = fresh.try_resume()
    fresh_state = _host(fresh.state) if in_mesh(fresh.mesh) else None
    after = [tr.step(), fresh.step()]
    lost = tr.fail_and_restore(1)
    restored = _host(tr.state) if in_mesh(tr.mesh) else None
    return {"ref_stats": ref_stats, "ref_state": ref_state, "stats": stats,
            "meshes": meshes, "path": path, "resumed": resumed,
            "state": state if rank == 0 else None,
            "fresh_state": fresh_state if rank == 0 else None,
            "after": after, "lost": lost,
            "restored": restored if rank == 0 else None,
            "model_parallel": (tr.model_parallel, fresh.model_parallel),
            "sharded": sorted(n for n, p in tr.state["params"]
                              .named_parameters()
                              if type(p).__name__ == "DTensor")}


def data_2_model_2_world(rank: int, ckpt_root: str, moe_flat, moe_x):
    """A world of 4 ranks: each arch's model-2 trainer schedule, then the
    MoE layer's decode (S = 1, ff over data) and train layouts on a (2, 2)
    mesh."""
    from repro_torch.elastic.resharding import make_job_mesh
    out = {arch: tp_schedule(rank, arch, f"{ckpt_root}/{arch}")
           for arch in ("stablelm-1.6b", "olmoe-1b-7b")}
    mesh = make_job_mesh(2, 2)
    out["moe decode"] = moe_case(mesh, moe_flat, moe_x, seq_one=True)
    out["moe train"] = moe_case(mesh, moe_flat, moe_x, seq_one=False)
    return out
