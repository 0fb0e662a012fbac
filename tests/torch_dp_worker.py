"""Worker processes of the port's data-parallel tests: each joins a gloo
world of CPU processes through a file in the test's temporary directory
(no port), runs one schedule and leaves its results in a file there.
Imports no JAX (each process starts from a fresh interpreter)."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import traceback

import torch

# every rank's wall limit on a collective (a lost peer fails the run)
COLLECTIVE_TIMEOUT_S = 60


def join(rank: int, world: int, init_file: str) -> None:
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def run(rank: int, fn, world: int, init_file: str, out: str, *args):
    """``fn(rank, *args)`` inside the world; its return value (or the
    error) is saved to ``out`` + the rank."""
    import torch.distributed as dist
    join(rank, world, init_file)
    try:
        result = {"ok": fn(rank, *args)}
    except Exception:   # the parent reads the error
        result = {"error": traceback.format_exc()}
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def elastic_config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).reduced()


def train_config(accum: int = 1):
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig, cosine_schedule
    return TrainConfig(compute_dtype=torch.float32, remat="none",
                       accum_steps=accum,
                       opt=AdamWConfig(lr=cosine_schedule(1e-3, 2, 10)))


# (action, argument): a width-1 trainer of the same seed runs the same
# steps with no resize
RESIZE_SCHEDULE = (("step", 2), ("resize", 2), ("step", 2), ("resize", 1),
                   ("step", 1))


def resize_schedule(rank: int, arch: str, accum: int = 1,
                    capacity_factor=None):
    """A trainer at width 1 through :data:`RESIZE_SCHEDULE`; returns each
    step's stats (empty on a rank outside the mesh), the plans' bytes and
    rank 0's final parameters and moments."""
    from repro_torch.elastic.manager import ElasticTrainer
    cfg = elastic_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    tr = ElasticTrainer(cfg, train_config(accum), global_batch=4,
                        seq_len=16, width=1, seed=0, device="cpu")
    stats, plans = [], []
    for action, arg in RESIZE_SCHEDULE:
        if action == "step":
            stats += [tr.step() for _ in range(arg)]
        else:
            plan = tr.resize(arg)
            plans.append((plan.old_dp, plan.new_dp, plan.bytes_moved))
    final = None
    if rank == 0:
        final = {"params": {n: p.detach().clone() for n, p in
                            tr.state["params"].named_parameters()},
                 "mu": {n: t.clone() for n, t in tr.state["opt"]["mu"].items()}}
    return {"stats": stats, "plans": plans, "final": final,
            "resizes": (tr.stats.resizes, tr.stats.expands,
                        tr.stats.shrinks), "step_num": tr.step_num}


def cli(rank: int, argv):
    """``launch.train.main(argv)`` in the world; returns (rc, stdout)."""
    from repro_torch.launch.train import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def elastic_world(rank: int, ckpt_dir: str):
    """Every schedule of the 2-rank world in one process start: stablelm's
    and olmoe's resizes, then the malleable CLI across widths 1 and 2."""
    return {
        "stablelm": resize_schedule(rank, "stablelm-1.6b"),
        "olmoe": resize_schedule(rank, "olmoe-1b-7b"),
        "olmoe accum 2": resize_schedule(rank, "olmoe-1b-7b", accum=2),
        "cli": cli(rank, [
            "--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
            "--steps", "6", "--batch", "4", "--seq", "16", "--malleable",
            "--resize-every", "2", "--fail-at", "5", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "2"]),
    }


def reshard_world(rank: int):
    """A (2, 2) mesh of 4 ranks: a tree and an LM placed by their specs
    from rank 0's values (the other ranks hold zeros), then gathered back
    onto a (1, 1) mesh."""
    from torch.distributed.tensor import DTensor
    from repro_torch.elastic.resharding import make_job_mesh, reshard_tree
    from repro_torch.models.sharding import tensor_specs
    from repro_torch.models.transformer import LM
    gen = torch.Generator().manual_seed(3)
    src = {"w": {"segments.0.0.attn.wq": torch.randn(8, 4, generator=gen),
                 "segments.0.1.attn.wq": torch.randn(8, 4, generator=gen),
                 "embed.table": torch.randn(6, 8, generator=gen),
                 "final_norm.scale": torch.randn(8, generator=gen)},
           "step": torch.tensor(7, dtype=torch.int32)}
    cfg = dataclasses.replace(elastic_config("stablelm-1.6b"), n_layers=2,
                              d_model=64, d_ff=128, vocab=256, name="mini")
    lm = LM(cfg, "cpu")
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    lm_src = {n: p.detach().clone() for n, p in lm.named_parameters()}
    if rank != 0:
        src = {"w": {k: torch.zeros_like(v) for k, v in src["w"].items()},
               "step": torch.tensor(0, dtype=torch.int32)}
        with torch.no_grad():
            for p in lm.parameters():
                p.zero_()
    tree = {"w": {k: v.clone() for k, v in src["w"].items()},
            "step": src["step"].clone()}
    mesh = make_job_mesh(2, 2)
    specs = tensor_specs(tree, mesh, fsdp=True)
    reshard_tree(tree, mesh, fsdp=True)
    lm_specs = tensor_specs({"lm": lm}, mesh)
    reshard_tree({"lm": lm}, mesh)
    out = {"coord": mesh.get_coordinate(), "specs": specs,
           "local": {k: (v.to_local().clone(), tuple(v.placements))
                     if isinstance(v, DTensor) else (v.clone(), None)
                     for k, v in tree["w"].items()},
           "full": {k: v.full_tensor().clone() if isinstance(v, DTensor)
                    else v.clone() for k, v in tree["w"].items()},
           "step": int(tree["step"]),
           "lm_sharded": sorted(n for n, p in lm.named_parameters()
                                if isinstance(p, DTensor)),
           "lm_specs": lm_specs}
    out["lm_full"] = {n: (p.full_tensor() if isinstance(p, DTensor)
                          else p).detach().clone()
                      for n, p in lm.named_parameters()}
    back = make_job_mesh(1, 1)
    reshard_tree(tree, back)
    out["back"] = {k: (type(v).__name__, v.clone())
                   for k, v in tree["w"].items()}
    try:
        make_job_mesh(3, 2)
        out["too_wide"] = None
    except ValueError as e:
        out["too_wide"] = str(e)
    out["rank0_src"] = {"w": src["w"], "lm": lm_src} if rank == 0 else None
    return out
