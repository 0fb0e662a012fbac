"""ElasticTrainer: a training job the cluster scheduler can resize.  The port
of the JAX package's ``elastic/manager.py``.

This is the bridge between the paper's contribution (``repro_torch.core``:
malleable job scheduling) and the ML substrate: one *malleable job* = one
ElasticTrainer.  The scheduler's expand / shrink operations call
:meth:`ElasticTrainer.resize`, which rebuilds the job's ``(data, model)``
mesh at the new data-parallel width and reshards the train state onto it
(:func:`repro_torch.elastic.resharding.reshard_tree`), reporting the
reconfiguration cost model back (:class:`~repro_torch.elastic.resharding.
ResizePlan`).

Every rank of the ``torch.distributed`` world runs the same program (one
process a card); the job's mesh is the world's first ``width`` ranks, the
others wait.  A step is data-parallel with the reference's global
semantics: each data rank takes its contiguous block of ``batch_for``'s
global batch (with gradient accumulation, its block of each microbatch),
and the step averages gradients, loss and its parts over the ranks before
clipping, compression and AdamW, with MoE layers routing as the global
batch (:func:`repro_torch.models.moe.data_parallel`).  With no process
group open, the trainer opens a world of one rank itself (NCCL on the
card, gloo on the CPU, through a ``FileStore`` in a temporary directory:
no port); :func:`close_world` closes it.

Fault tolerance: ``step()`` checkpoints every ``ckpt_every`` steps (rank 0
writes, the other ranks wait at a barrier); on an injected node failure the
trainer restores the last checkpoint at the surviving width: rank 0 reads
it and the new mesh receives it by broadcast.

With ``model_parallel`` > 1 the mesh is ``(data = width, model =
model_parallel)`` over the world's first ``width * model_parallel``
ranks: the state is placed by the partition rules, each rank takes its
data coordinate's rows, and the step runs tensor-parallel over its model
group (:mod:`repro_torch.models.tp`), its gradients averaged over the
``data`` group alone.  A checkpoint gathers the state whole (the ranks of
data coordinate 0 join the gathers, rank 0 writes): the same files as a
run at ``model_parallel`` 1 writes.  Resize, failure restore and resume
keep ``model_parallel``.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (to_tensors, train_state_into,
                                 train_state_to_numpy)
from repro_torch.launch.mesh import world_device_type, world_size
from repro_torch.train.data import batch_for
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .resharding import (ResizePlan, gather_tree, in_mesh, make_job_mesh,
                         reshard_tree, resize_plan)

_OWNED: Dict[str, Any] = {}   # the world this module opened: its store dir


def ensure_world(device) -> None:
    """Open a ``torch.distributed`` world of one rank (NCCL for a CUDA
    device, gloo for the CPU; a ``FileStore`` in a temporary directory)
    unless a process group is open."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    path = tempfile.mkdtemp(prefix="repro_world_")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(path, "store"), 1), rank=0, world_size=1)
    _OWNED["dir"] = path


def close_world() -> None:
    """Close the world :func:`ensure_world` opened (nothing otherwise)."""
    import torch.distributed as dist
    path = _OWNED.pop("dir", None)
    if path is not None:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(path, ignore_errors=True)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world_int(value: Optional[int]) -> Optional[int]:
    """Rank 0's ``value`` (None as -1 on the wire) on every rank."""
    if world_size() == 1:
        return value
    import torch.distributed as dist
    t = torch.tensor([-1 if value is None else value], dtype=torch.int64,
                     device=world_device_type())
    dist.broadcast(t, src=0)
    out = int(t.item())
    return None if out < 0 else out


def _barrier() -> None:
    if world_size() > 1:
        import torch.distributed as dist
        dist.barrier()


def local_rows(global_batch: int, width: int, accum: int, rank: int):
    """The global batch's rows data rank ``rank`` of ``width`` takes: its
    contiguous block, or with ``accum`` microbatches its block of each
    (so a microbatch of the ranks is the global step's microbatch)."""
    if global_batch % (width * max(accum, 1)):
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{width} ranks x {max(accum, 1)} microbatches")
    micro = global_batch // max(accum, 1)
    share = micro // width
    return np.concatenate([np.arange(i * micro + rank * share,
                                     i * micro + (rank + 1) * share)
                           for i in range(max(accum, 1))])


def state_like(state):
    """The JAX layout of a port train state (as ``train_state_to_numpy``
    gives it) with an array of no storage for each leaf: the tree a
    restore reads shapes from."""
    from repro_torch.models.sharding import stacked_shapes

    def like(tree):
        return {k: np.broadcast_to(np.float32(0), shape)
                for k, shape in stacked_shapes(tree).items()}

    out = {"params": like(state["params"]),
           "opt": {k: like(v) for k, v in state["opt"].items()
                   if k != "step"}}
    out["opt"]["step"] = np.int32(0)
    if "ef" in state:
        out["ef"] = like(state["ef"])
    return out


@dataclasses.dataclass
class ElasticStats:
    steps: int = 0
    resizes: int = 0
    expands: int = 0
    shrinks: int = 0
    restores: int = 0
    resize_seconds: float = 0.0
    step_seconds: List[float] = dataclasses.field(default_factory=list)


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *,
                 global_batch: int, seq_len: int, width: int,
                 model_parallel: int = 1, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, seed: int = 0, device=None):
        self.device = resolve_device(device)
        ensure_world(self.device)
        self.cfg = cfg
        self.tc = tc
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.model_parallel = model_parallel
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.stats = ElasticStats()
        self._step: Optional[tuple] = None   # (width, its step function)
        self.width = width
        self.mesh = make_job_mesh(width, model_parallel, self.device.type)
        self.state = init_train_state(
            cfg, tc, torch.Generator(self.device).manual_seed(seed),
            self.device)
        self.state = reshard_tree(self.state, self.mesh)
        self.step_num = 0

    # ------------------------------------------------------------- steps
    def _step_fn(self):
        """The step at the mesh's width, built again after a width change."""
        if self._step is None or self._step[0] != self.width:
            group = (self.mesh.get_group("data") if self.width > 1 else None)
            self._step = (self.width,
                          make_train_step(self.cfg, self.tc, group))
        return self._step[1]

    def _device_batch(self, step: int):
        batch = batch_for(self.cfg, self.seq_len, self.global_batch,
                          step=step, seed=self.seed)
        if self.width > 1:
            rows = local_rows(self.global_batch, self.width,
                              self.tc.accum_steps,
                              self.mesh.get_coordinate()[0])
            batch = {k: v[rows] for k, v in batch.items()}
        return to_tensors(batch, self.device)

    def step(self) -> Dict[str, float]:
        """One step of the job (a rank outside the mesh only counts it and
        returns no stats)."""
        t0 = time.monotonic()
        out: Dict[str, float] = {}
        if in_mesh(self.mesh):
            batch = self._device_batch(self.step_num)
            self.state, stats = self._step_fn()(self.state, batch)
            # the card's stats cross to the host in one copy (one wait for
            # the card); the learning rate is computed on the host
            on_card = [k for k, v in stats.items()
                       if torch.is_tensor(v) and v.device.type != "cpu"]
            vals = dict(zip(on_card, torch.stack(
                [stats[k].detach().double() for k in on_card]).tolist())
                if on_card else [])
            out = {k: vals[k] if k in vals else float(v)
                   for k, v in stats.items()}
        self.step_num += 1
        self.stats.steps += 1
        self.stats.step_seconds.append(time.monotonic() - t0)
        if self.ckpt_dir and self.step_num % self.ckpt_every == 0:
            self.checkpoint()
        return out

    # ----------------------------------------------------------- elastic
    def _host_state(self):
        for name, p in self.state["params"].named_parameters():
            if p.dtype == torch.bfloat16:
                raise ValueError(f"checkpoint leaf params/{name} is "
                                 "bfloat16, which numpy cannot hold; train "
                                 "with f32 parameters to checkpoint")
        return train_state_to_numpy(self.state)

    def checkpoint(self) -> Optional[str]:
        """Rank 0 writes the state (gathered whole by the ranks of its data
        coordinate under tensor parallelism); every rank returns the path
        once it is written."""
        if not self.ckpt_dir:
            return None
        path = os.path.join(self.ckpt_dir, f"step_{self.step_num:08d}")
        coord = self.mesh.get_coordinate()
        if _rank() == 0 or (self.model_parallel > 1 and coord is not None
                            and coord[0] == 0):
            host = self._host_state()
            if _rank() == 0:
                path = save_checkpoint(self.ckpt_dir, self.step_num, host)
        _barrier()
        return path

    def _restore(self, step: int) -> None:
        """Rank 0 loads checkpoint ``step`` into its state; the mesh then
        receives it."""
        gather_tree(self.state)
        if _rank() == 0:
            restored, _ = restore_checkpoint(self.ckpt_dir,
                                             state_like(self.state), step)
            train_state_into(self.state, restored)
        self.state = reshard_tree(self.state, self.mesh)

    def resize(self, new_width: int) -> ResizePlan:
        """Scheduler-initiated expand/shrink to ``new_width`` hosts."""
        if new_width == self.width:
            return resize_plan(self.state, self.width, new_width)
        t0 = time.monotonic()
        plan = resize_plan(self.state, self.width, new_width)
        self.stats.resizes += 1
        if new_width > self.width:
            self.stats.expands += 1
        else:
            self.stats.shrinks += 1
        self.width = new_width
        self.mesh = make_job_mesh(new_width, self.model_parallel,
                                  self.device.type)
        self.state = reshard_tree(self.state, self.mesh)
        self.stats.resize_seconds += time.monotonic() - t0
        return plan

    def try_resume(self) -> Optional[int]:
        """Restore the latest checkpoint if one exists (restart path)."""
        if not self.ckpt_dir:
            return None
        step = _world_int(latest_step(self.ckpt_dir) if _rank() == 0
                          else None)
        if step is None:
            return None
        self._restore(step)
        self.step_num = step
        return step

    def fail_and_restore(self, surviving_width: int) -> int:
        """Node failure: restart from the last checkpoint on fewer hosts.

        Returns the number of steps lost (recomputed)."""
        if not self.ckpt_dir:
            raise RuntimeError("failure recovery requires a ckpt_dir")
        self.stats.restores += 1
        self.width = surviving_width
        self.mesh = make_job_mesh(surviving_width, self.model_parallel,
                                  self.device.type)
        step = _world_int(latest_step(self.ckpt_dir) if _rank() == 0
                          else None)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        self._restore(step)
        lost = self.step_num - step
        self.step_num = step
        return lost
