"""Chunked, sharded execution for the port's batched sweep engine.

The port of ``repro.sweep.shard``.
:func:`repro_torch.sweep.batch.simulate_lanes` holds every lane of a grid
in one device-resident batch; this module turns that into a *plan*: the
lane axis is partitioned into fixed-width chunks, and each chunk is

1. **streamed sequentially** -- the ``chunk_lanes`` budget caps how many
   lanes are resident at once, and every completed chunk is handed back to
   the caller *before* the next one starts, so the experiment backend can
   flush its cells into the cell store (:mod:`repro_torch.sweep.cache`) and
   an interrupted paper-scale run resumes chunk by chunk;

2. **split across cards** -- a chunk is cut into ``devices`` contiguous,
   equal pieces over the lane mesh (:func:`lane_sharding`,
   :func:`shard_lanes`), piece ``i`` runs on ``cuda:i`` in a thread of its
   own, and the pieces' results are stitched back in lane order.  Lanes
   never talk to each other, so the pieces share nothing but the lane
   statics.

Both are *execution* choices, never *experiment* choices: every piece runs
with the **full** batch's :func:`~repro_torch.sweep.batch.lane_statics`
(priority and level-bisection bounds, the class / SJF flags, the depth
cutoff, the starting window), and padding lanes repeat a real lane, so a
lane's result does not depend on the plan: chunked, split and monolithic
runs are bit-identical (``tests/test_torch_shard.py``), and no knob of the
plan enters a spec or cell fingerprint.

A piece that ends before another has a shorter event timeline; its rows
are extended with their last entry, the zero-width entry with no busy node
that the engine itself appends to a finished lane, so the stitched
timeline means what one batch's would.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.jobs import DONE
from repro_torch.launch.mesh import MeshView, make_lane_mesh

from .batch import (BatchedLanes, EngineConfig, lane_statics, pad_lanes,
                    simulate_lanes, take_lanes)

# result scalars of the pieces of one chunk: these take the pieces' largest
# value (the pieces run side by side), every other scalar their sum
_PEAK_FIELDS = ("steps", "window", "compile_s", "execute_s",
                "compile_variants")


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Results-neutral execution plan for one batched sweep.

    ``chunk_lanes``: at most this many lanes are device-resident at once
    (0 = the whole batch as one chunk).  ``devices``: how many pieces each
    chunk is split into, one a card (0 = every visible card, 1 = no split).
    Neither can change a cell's result, so neither is ever part of a spec
    or cell fingerprint.
    """

    chunk_lanes: int = 0
    devices: int = 0

    def __post_init__(self) -> None:
        if self.chunk_lanes < 0:
            raise ValueError("chunk_lanes must be >= 0 (0 = unbounded)")
        if self.devices < 0:
            raise ValueError("devices must be >= 0 (0 = every card)")


class ChunkResult(NamedTuple):
    """One executed lane chunk of a :func:`simulate_lanes_chunked` stream.

    ``results`` is the :func:`~repro_torch.sweep.batch.simulate_lanes` dict
    sliced back to the chunk's real lanes ``[lo, hi)`` (padding rows
    dropped); ``lane_width`` is the padded width the chunk ran at,
    ``wall_s`` its wall-clock, ``n_devices`` the pieces it was split into.
    """

    lo: int
    hi: int
    results: Dict[str, np.ndarray]
    wall_s: float
    lane_width: int
    n_devices: int


def resolve_devices(n_devices: int, device=None) -> List[torch.device]:
    """The devices the pieces of a chunk run on, one a piece.

    On ``cuda`` (the default) piece ``i`` runs on ``cuda:i``; ``n_devices=0``
    means every visible card, and more than ``torch.cuda.device_count()``
    raises.  A device with an index (``cuda:0``) or the CPU takes every
    piece itself, so the split runs on one card or on the CPU too.
    """
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * max(1, n_devices)
    count = torch.cuda.device_count()
    if n_devices == 0:
        n_devices = count
    if n_devices > count:
        raise ValueError(f"plan wants {n_devices} devices but only {count} "
                         "CUDA device(s) are visible")
    return [torch.device("cuda", i) for i in range(n_devices)]


def chunk_plan(n_lanes: int, chunk_lanes: int,
               n_devices: int = 1) -> Tuple[int, List[Tuple[int, int]]]:
    """Partition ``n_lanes`` into ``[lo, hi)`` ranges plus their width.

    The width is the lane budget rounded **up** to a multiple of
    ``n_devices`` (a chunk splits evenly into its pieces) and is the same
    for every chunk: a short final chunk is padded up to it.
    """
    if n_lanes < 1:
        raise ValueError("a plan needs at least one lane")
    n_devices = max(1, n_devices)
    budget = chunk_lanes if chunk_lanes > 0 else n_lanes
    budget = min(budget, n_lanes)
    width = -(-budget // n_devices) * n_devices
    ranges = [(lo, min(lo + width, n_lanes))
              for lo in range(0, n_lanes, width)]
    return width, ranges


def _lanes_to(batch: BatchedLanes, device) -> BatchedLanes:
    return BatchedLanes(*[getattr(batch, name).to(device)
                          for name in BatchedLanes._fields])


class LaneSharding(NamedTuple):
    """A lane batch's placement: its leading axis split over ``mesh``'s
    ``lanes`` axis (the reference's ``NamedSharding(mesh,
    PartitionSpec("lanes"))``)."""

    mesh: MeshView
    placements: tuple


def lane_sharding(devices) -> LaneSharding:
    """The placement splitting lane-leading arrays over ``devices``."""
    from torch.distributed.tensor import Shard
    return LaneSharding(make_lane_mesh(devices), (Shard(0),))


def shard_lanes(batch: BatchedLanes, sharding: LaneSharding
                ) -> List[BatchedLanes]:
    """``batch`` cut into equal contiguous pieces of its lanes, piece ``i``
    on the mesh's device ``i`` (as the reference's sharding splits axis 0;
    the lane count must divide)."""
    devices = sharding.mesh.devices
    n = len(devices)
    if batch.n_lanes % n:
        raise ValueError(f"{batch.n_lanes} lanes do not split over {n} "
                         "devices")
    size = batch.n_lanes // n
    return [_lanes_to(take_lanes(batch, i * size, (i + 1) * size), dev)
            for i, dev in enumerate(devices)]


def _run_piece(simulate, piece: BatchedLanes, device, cfg: EngineConfig,
               statics: Dict[str, int], verbose: bool) -> Dict:
    if device.type == "cuda":
        torch.cuda.set_device(device)  # this thread's launches go there
    return simulate(_lanes_to(piece, device), cfg, verbose=verbose,
                    statics=statics)


def _stitch(parts: List[Dict]) -> Dict:
    """The pieces' result dicts as one, lanes in piece order."""
    span = max(p["trace_t"].shape[1] for p in parts)
    out = {}
    for key, first in parts[0].items():
        vals = [p[key] for p in parts]
        if isinstance(first, np.ndarray) and first.ndim >= 1:
            if key.startswith("trace_"):
                vals = [np.pad(v, ((0, 0), (0, span - v.shape[1])),
                               mode="edge") for v in vals]
            out[key] = np.concatenate(vals, axis=0)
        elif key in _PEAK_FIELDS:
            out[key] = max(vals)
        elif key != "finished":
            out[key] = sum(vals)
    out["finished"] = bool(np.all(out["state"] == DONE))
    return out


def _run_chunk(simulate, sub: BatchedLanes, devices, cfg, statics, verbose,
               pool):
    if pool is None:
        return _run_piece(simulate, sub, devices[0], cfg, statics, verbose)
    pieces = shard_lanes(sub, lane_sharding(devices))
    futs = [pool.submit(_run_piece, simulate, piece, dev, cfg, statics,
                        verbose)
            for piece, dev in zip(pieces, devices)]
    return _stitch([f.result() for f in futs])


def simulate_lanes_chunked(
    batch: BatchedLanes,
    cfg: EngineConfig,
    shard: ShardConfig = ShardConfig(),
    verbose: bool = False,
    device=None,
    simulate=simulate_lanes,
) -> Iterator[ChunkResult]:
    """Run ``batch`` as a stream of lane chunks; yield each as it finishes.

    ``device`` picks the pieces' devices (:func:`resolve_devices`; default:
    the batch's device type, so a batch on ``cuda`` splits over the
    cards).  ``simulate`` is the engine each piece runs (a test may stand
    in for it).  With the default plan on one card this is
    one chunk covering the whole batch: the monolithic
    :func:`~repro_torch.sweep.batch.simulate_lanes` path.  Chunks run in
    lane order; a consumer that stores each yielded chunk's cells before
    pulling the next resumes chunk by chunk
    (:mod:`repro_torch.experiments.backend_torch` does).
    """
    devices = resolve_devices(shard.devices, batch.submit.device.type
                              if device is None else device)
    width, ranges = chunk_plan(batch.n_lanes, shard.chunk_lanes,
                               len(devices))
    # every piece runs with the FULL batch's statics: a chunk-local span_max,
    # class flag, SJF flag or peak-active bound would perturb its lanes
    statics = lane_statics(batch)
    pool = (concurrent.futures.ThreadPoolExecutor(
        len(devices), thread_name_prefix="sweep-shard")
        if len(devices) > 1 else None)
    try:
        for lo, hi in ranges:
            sub = pad_lanes(take_lanes(batch, lo, hi), width)
            if verbose and (len(ranges) > 1 or pool is not None):
                print(f"[sweep.shard] lanes [{lo}, {hi}) of {batch.n_lanes} "
                      f"at width {width} on {len(devices)} device(s)")
            t0 = time.monotonic()
            with obs.span("sweep.chunk", lo=lo, hi=hi, width=width,
                          devices=len(devices)):
                with obs.span("sweep.execute", structure=cfg.structure,
                              lanes=width, jobs=batch.n_jobs):
                    res = _run_chunk(simulate, sub, devices, cfg, statics,
                                     verbose, pool)
            wall = time.monotonic() - t0
            m = hi - lo
            out = {k: (v[:m] if isinstance(v, np.ndarray) and v.ndim >= 1
                       and v.shape[0] == width else v)
                   for k, v in res.items()}
            out["finished"] = bool(np.all(out["state"] == DONE))
            yield ChunkResult(lo, hi, out, wall, width, len(devices))
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def describe_plan(n_lanes: int, shard: ShardConfig,
                  n_devices: Optional[int] = None) -> Dict[str, int]:
    """Plan summary (chunk count / width / devices) for logs, without
    touching a device when ``n_devices`` is given."""
    if n_devices is None:
        n_devices = len(resolve_devices(shard.devices))
    width, ranges = chunk_plan(n_lanes, shard.chunk_lanes, n_devices)
    return {"n_lanes": n_lanes, "chunks": len(ranges),
            "lane_width": width, "devices": n_devices}
