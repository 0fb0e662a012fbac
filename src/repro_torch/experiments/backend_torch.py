"""Batched PyTorch experiment backend: the whole grid as device lanes.

The port of ``repro.experiments.backend_jax.run_cells``: cells become lanes
grouped by static pass structure (greedy-structured strategies EASY / MIN /
PREF / KEEPPREF / RIGID_SJF share one batch; AVG runs a balanced batch,
PREF_COMMON_POOL a pooled one and STEAL_AGREEMENT a stealing one; each
structure's ``<structure>_lanes`` / ``_steps`` / ``_window`` land in
``info``), the scenario's queue order and job classes travel in the lanes,
lanes of different workloads pad-stack into one batch
(:func:`repro_torch.sweep.batch.concat_lanes`), and per-cell metrics come
back through :mod:`repro_torch.sweep.metrics`.  Only lanes that ran to
completion are written to the cell store.

Each structure's batch runs through the chunked plan
(:func:`repro_torch.sweep.shard.simulate_lanes_chunked`): ``chunk_lanes``
streams it as sequential lane chunks and ``devices`` splits every chunk
across cards.  Each completed chunk's cells are written to the store
before the next chunk starts, so an interrupted run resumes chunk by
chunk.  The default plan on one card is one monolithic chunk; every plan
gives the same cells bit for bit, so neither knob is fingerprinted.

Flight recorder (:mod:`repro_torch.obs`, off unless ``--trace`` asks): a
``sweep.chunk`` span around each chunk, holding a ``sweep.execute`` span
around its engine run, which ends in the host copies of its results, so
the spans add no synchronise of their own; ``sweep.escalations`` counts
window escalations.  ``options["progress"]`` prints a heartbeat line per
structure batch.

Backend options (results-neutral, not part of the spec): ``device``
(``cuda`` unless ``"cpu"`` is asked for), ``expand_backend``
(``fused`` | ``waterfill`` | ``bisect``; ``auto`` = fused on cuda),
``window``, ``chunk``, ``max_steps_factor``, ``events``, ``chunk_lanes``
(max resident lanes, 0 = the whole batch), ``devices`` (cards a chunk is
split across, 0 = every visible card), ``progress``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core import DONE, get_strategy
from repro_torch.sweep.batch import (EngineConfig, build_lanes, concat_lanes,
                                     simulate_lanes)
from repro_torch.sweep.cache import SweepCache
from repro_torch.sweep.metrics import batched_metrics
from repro_torch.sweep.shard import ShardConfig, simulate_lanes_chunked

from .spec import Cell, ExperimentSpec, prepare_workload


def engine_config(structure: str, opts: Dict) -> EngineConfig:
    """The engine configuration of one structure batch from the backend
    options (shared with the what-if service's executor)."""
    return EngineConfig(structure=structure,
                        window=int(opts.get("window", 0)),
                        chunk=int(opts.get("chunk", 160)),
                        max_steps_factor=int(opts.get("max_steps_factor",
                                                      16)),
                        expand_backend=opts.get("expand_backend", "auto"),
                        events=int(opts.get("events", 4)))


def chunk_metrics(ch, big, win0, win1, caps) -> List[Dict[str, float]]:
    """Per-lane metric dicts of one chunk, ``sched_*`` counters attached.

    ``batched_metrics`` takes the chunk's slice ``[lo, hi)`` of the
    unpadded batch's ``submit`` / ``malleable`` / window / capacity; the
    chunk's results already dropped their padding lanes.
    """
    res, lo, hi = ch.results, ch.lo, ch.hi
    per_lane = batched_metrics(res, big.submit[lo:hi], big.malleable[lo:hi],
                               (win0[lo:hi], win1[lo:hi]), caps[lo:hi])
    shrink_ev = np.sum(res["shrink_ops"], axis=1)
    expand_ev = np.sum(res["expand_ops"], axis=1)
    for i, m in enumerate(per_lane):
        m["sched_backfill_starts"] = float(res["bf_starts"][i])
        m["sched_shrink_events"] = float(shrink_ev[i])
        m["sched_expand_events"] = float(expand_ev[i])
        m["sched_invocations"] = float(res["sched_steps"][i])
    return per_lane


def run_cells(spec: ExperimentSpec,
              todo: List[Tuple[str, Cell]],
              store: Optional[SweepCache],
              fingerprints: Dict[Tuple[str, Cell], Dict],
              options: Optional[Dict] = None,
              verbose: bool = True) -> Tuple[Dict, Dict]:
    """Run ``todo`` cells on the batched engine; one batch per structure.

    Returns ``(metrics, info)``: per-(workload, cell) metric dicts (with the
    ``sched_*`` scheduling counters) and an info dict of per-structure
    lanes / steps / peak window, one ``info["chunks"]`` entry per chunk
    (its lanes ``[lo, hi)``, width, devices, wall, steps, window), wall
    seconds, the cells computed and the incomplete ones (cut off by the
    step budget: returned, never stored).
    """
    opts = options or {}
    device = resolve_device(opts.get("device"))
    shard = ShardConfig(chunk_lanes=int(opts.get("chunk_lanes", 0)),
                        devices=int(opts.get("devices", 0)))
    names = [n for n in spec.workloads if any(n == m for m, _ in todo)]
    wls = {name: prepare_workload(spec, name) for name in names}

    groups: Dict[str, List[Tuple[str, Cell]]] = {}
    for k in todo:
        groups.setdefault(get_strategy(k[1][0]).structure, []).append(k)
    t0 = time.monotonic()
    metrics: Dict[Tuple[str, Cell], Dict[str, float]] = {}
    info: Dict[str, object] = {"incomplete": [], "chunks": [],
                               "chunk_lanes": shard.chunk_lanes,
                               "peak_lane_width": 0,
                               "execute_s": 0.0, "escalations": 0,
                               "compressed_events": 0, "sched_steps": 0,
                               "device": str(device)}
    heartbeat = obs.Heartbeat(len(groups),
                              label=f"progress:{'+'.join(names)}",
                              unit="batch",
                              enabled=bool(opts.get("progress")))
    for structure, group in groups.items():
        # group is workload-major, matching the per-name lane stacking
        group.sort(key=lambda k: names.index(k[0]))
        batches, t0s, t1s, caps = [], [], [], []
        for name in names:
            lanes = [(get_strategy(s), p, sd)
                     for wname, (s, p, sd) in group if wname == name]
            if not lanes:
                continue
            cl, w_rigid, window = wls[name]
            batch, _order = build_lanes(
                w_rigid, cl.nodes, lanes, config=spec.transform,
                tick=cl.tick, backfill_depth=spec.scenario.backfill_depth,
                queue_order=spec.scenario.queue_order, device=device)
            batches.append(batch)
            t0s += [window.t0] * len(lanes)
            t1s += [window.t1] * len(lanes)
            caps += [cl.nodes] * len(lanes)
        big = concat_lanes(batches) if len(batches) > 1 else batches[0]
        win0, win1, caps_arr = np.asarray(t0s), np.asarray(t1s), \
            np.asarray(caps)
        cfg = engine_config(structure, opts)
        steps_total, window_peak, flushed, budget_cut = 0, 0, 0, False
        # the engine is read from this module at call time, so a test can
        # stand in for it here
        for ch in simulate_lanes_chunked(big, cfg, shard, verbose=verbose,
                                         device=opts.get("device"),
                                         simulate=simulate_lanes):
            res = ch.results
            obs.counter("sweep.escalations", int(res["escalations"]))
            per_lane = chunk_metrics(ch, big, win0, win1, caps_arr)
            lane_done = np.all(res["state"] == DONE, axis=1)
            # stored before the next chunk runs: a stream cut off here
            # resumes from the last finished chunk
            for key, m, done in zip(group[ch.lo:ch.hi], per_lane,
                                    lane_done):
                metrics[key] = m
                if bool(done):
                    if store is not None:
                        store.put(fingerprints[key], m)
                        flushed += 1
                else:
                    info["incomplete"].append(key)
            steps_total += int(res["steps"])
            window_peak = max(window_peak, int(res["window"]))
            budget_cut = budget_cut or not res["finished"]
            info["chunks"].append({
                "structure": structure, "lo": ch.lo, "hi": ch.hi,
                "lanes": ch.hi - ch.lo, "lane_width": ch.lane_width,
                "devices": ch.n_devices, "wall_s": ch.wall_s,
                "steps": int(res["steps"]), "window": int(res["window"]),
                "execute_s": float(res["execute_s"]),
                "escalations": int(res["escalations"]),
                "sched_steps": int(np.sum(res["sched_steps"])),
                "compressed_events": int(res["compressed_events"]),
            })
            info["execute_s"] += float(res["execute_s"])
            info["escalations"] += int(res["escalations"])
            info["sched_steps"] += int(np.sum(res["sched_steps"]))
            info["compressed_events"] += int(res["compressed_events"])
            info["peak_lane_width"] = max(info["peak_lane_width"],
                                          ch.lane_width)
            info["devices"] = ch.n_devices
        info[f"{structure}_lanes"] = len(group)
        info[f"{structure}_steps"] = steps_total
        info[f"{structure}_window"] = window_peak
        heartbeat.tick(cells_flushed=flushed, extra=structure)
        if budget_cut and verbose:
            print(f"[experiment-torch:{'+'.join(names)}] WARNING: "
                  f"{structure} batch hit the step budget with unfinished "
                  "lanes")
    info["sim_seconds"] = time.monotonic() - t0
    info["computed_cells"] = len(todo) - len(info["incomplete"])
    return metrics, info
