"""What-if scheduling as a service: a request-coalescing query engine.

The port of ``repro.serve.whatif`` over the port's engines (``torch``,
the batched engine on the card, and ``des``, the numpy DES on the host).

The paper's headline question — *what happens to my cluster if X% of
jobs go malleable / backfill depth changes / a strategy is swapped* — is
one **cell** of the experiment grid.  This module turns the existing
machinery (engine-agnostic cell store, one-compilation padded lane
batching, chunk streaming) into a persistent low-latency answer path:

* a :class:`WhatIfQuery` is a *delta* on a base :class:`ExperimentSpec`
  (strategy / proportion / seed / backfill depth / queue order / job-class
  mix / walltime + arrival axes);
* cache hits are answered straight from an in-memory memo or the shared
  cell store (:mod:`repro_torch.sweep.cache`) at memory speed —
  bit-identical to a :func:`repro_torch.experiments.run_experiment` run
  of the same spec, because the store key *is* the cell fingerprint (a
  ``des`` cell's key is the JAX package's, so both packages share DES
  cells);
* cache misses are **coalesced**: concurrent queries land in a bounded
  queue and a single dispatcher thread admits them as one batch (up to
  ``max_batch`` queries, waiting at most ``max_wait_s`` for stragglers),
  then executes the whole batch at once — on the torch engine every
  query becomes one padded lane of one device batch
  (:func:`repro_torch.sweep.batch.concat_lanes`), so N concurrent
  what-ifs cost one engine invocation, streamed back per chunk
  (:func:`repro_torch.sweep.shard.simulate_lanes_chunked`) as results
  finish;
* identical in-flight queries are **deduplicated** (they attach to the
  pending computation instead of queueing twice);
* failure is **per query**: a lane that hits the engine step budget (or
  an executor error) rejects only the affected queries' futures — the
  dispatcher and every other query in the batch survive.

Determinism contract: coalescing is semantics-free.  Any answer served
through this engine — hit, single miss, coalesced miss, any interleaving
— is bit-identical to ``run_experiment`` on the equivalent spec
(``tests/test_torch_whatif.py``), because per-lane results are
independent of batch composition (the chunk/concat bit-parity property
of the batched engine) and the DES path runs the very same
:func:`repro_torch.experiments.backend_des.simulate_cell`.

Testability: the wall clock (:class:`MonotonicClock`) and the batch
executor are injectable, so the concurrency tests drive "N queries land
in one batch" / "max-wait fires with a partial batch" / "mid-batch
failure poisons only the failing query" without real sleeps.

Threads: every device operation of a miss batch runs on the one
dispatcher thread (``whatif-dispatcher``), which makes the engine's
device its current CUDA device; client and HTTP threads only submit and
wait.  The ``torch`` engine runs on ``cuda`` unless the backend options
say ``device="cpu"``: without a card, constructing it raises.  A
DES-engine service touches no device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs, resolve_device
from repro_torch.core import CLUSTERS
from repro_torch.core.scenario import JobClasses
from repro_torch.core.strategies import STRATEGIES
from repro_torch.experiments.spec import Cell, ExperimentSpec
from repro_torch.sweep.cache import SweepCache


class QueueFullError(RuntimeError):
    """The engine's bounded admission queue is full; retry later."""


class EngineClosedError(RuntimeError):
    """The engine is closed and no longer accepts queries."""


class QueryFailedError(RuntimeError):
    """This query's computation failed; other queries are unaffected."""


# ----------------------------------------------------------------------
# queries
_SCENARIO_OVERRIDES = ("backfill_depth", "queue_order", "walltime_factor",
                       "walltime_jitter", "arrival_compression")
_CLASS_OVERRIDES = ("rigid_frac", "on_demand_frac", "class_seed")


@dataclasses.dataclass(frozen=True)
class WhatIfQuery:
    """One what-if question: a delta on the service's base spec.

    ``None`` fields inherit the base spec's scenario.  ``proportion`` is
    the malleable fraction (0 = the rigid baseline, regardless of
    strategy, exactly like the grid's proportion-0 column); ``seed`` is
    the rigid->malleable transform seed.
    """

    strategy: str = "min"
    proportion: float = 1.0
    workload: Optional[str] = None       # None = the base spec's first
    seed: int = 0
    backfill_depth: Optional[int] = None
    queue_order: Optional[str] = None
    walltime_factor: Optional[float] = None
    walltime_jitter: Optional[float] = None
    arrival_compression: Optional[float] = None
    rigid_frac: Optional[float] = None
    on_demand_frac: Optional[float] = None
    class_seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        if not 0.0 <= self.proportion <= 1.0:
            raise ValueError(f"proportion {self.proportion} outside [0, 1]")
        if self.workload is not None and self.workload not in CLUSTERS:
            raise ValueError(f"unknown workload {self.workload!r}; "
                             f"choose from {sorted(CLUSTERS)}")
        if self.queue_order not in (None, "fcfs", "sjf"):
            raise ValueError(f"unknown queue_order {self.queue_order!r}")

    # -- normalization --------------------------------------------------
    def cell(self) -> Cell:
        """The store cell this query resolves to.

        Mirrors :meth:`ExperimentSpec.cells`: proportion 0 *is* the rigid
        baseline cell whatever the strategy, and a non-malleable strategy
        (``rigid_sjf``) contributes its single proportion-0 cell.
        """
        if not STRATEGIES[self.strategy].malleable:
            return (self.strategy, 0.0, 0)
        if self.proportion == 0.0:
            return ("easy", 0.0, 0)
        return (self.strategy, float(self.proportion), int(self.seed))

    def spec_for(self, base: ExperimentSpec) -> ExperimentSpec:
        """The single-workload spec this query means, given ``base``."""
        workload = self.workload or base.workloads[0]
        scen = base.scenario
        over = {name: getattr(self, name) for name in _SCENARIO_OVERRIDES
                if getattr(self, name) is not None}
        if any(getattr(self, n) is not None for n in _CLASS_OVERRIDES):
            rf = (self.rigid_frac if self.rigid_frac is not None
                  else scen.job_classes.rigid)
            od = (self.on_demand_frac if self.on_demand_frac is not None
                  else scen.job_classes.on_demand)
            over["job_classes"] = JobClasses(
                rigid=rf, on_demand=od, malleable=1.0 - rf - od,
                seed=(self.class_seed if self.class_seed is not None
                      else scen.job_classes.seed))
        if over:
            scen = dataclasses.replace(scen, **over)
        return dataclasses.replace(base, workloads=(workload,),
                                   scenario=scen)

    # -- wire formats ---------------------------------------------------
    def to_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: Dict) -> "WhatIfQuery":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown query field(s) {sorted(unknown)}; "
                             f"choose from {sorted(fields)}")
        return cls(**d)

    @classmethod
    def parse(cls, text: str) -> "WhatIfQuery":
        """Parse the CLI shorthand ``k=v,k=v`` (numbers auto-typed)."""
        out: Dict = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(f"expected k=v, got {part!r}")
            k, v = part.split("=", 1)
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
            out[k.strip()] = v
        return cls.from_dict(out)


def sample_queries(seed: int, n: int, *, workloads: Sequence[str],
                   strategies: Sequence[str] = ("min", "pref", "avg",
                                                "keeppref"),
                   proportions: Sequence[float] = (0.0, 0.25, 0.5, 1.0),
                   seeds: int = 1,
                   depths: Sequence[Optional[int]] = (None,),
                   orders: Sequence[Optional[str]] = (None,),
                   ) -> List[WhatIfQuery]:
    """A seeded random query population (CLI storms, load benchmarks)."""
    import random

    rng = random.Random(seed)
    return [WhatIfQuery(workload=rng.choice(list(workloads)),
                        strategy=rng.choice(list(strategies)),
                        proportion=rng.choice(list(proportions)),
                        seed=rng.randrange(max(1, seeds)),
                        backfill_depth=rng.choice(list(depths)),
                        queue_order=rng.choice(list(orders)))
            for _ in range(n)]


# ----------------------------------------------------------------------
# injectable clock
class MonotonicClock:
    """Default wall clock: ``now`` + a condition-variable wait.

    Both are injectable so the concurrency tests replace real time with a
    stepped fake (advance + notify) — admission decisions key on
    ``now()``, never on how long a ``wait`` really slept.
    """

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cv: threading.Condition,
             timeout: Optional[float]) -> bool:
        return cv.wait(timeout)


# ----------------------------------------------------------------------
# pending queries
class _Pending:
    """One admitted query: resolved spec + the futures waiting on it.

    Executors see these as *tasks*: read ``.spec`` / ``.workload`` /
    ``.cell``, then call :meth:`resolve` or :meth:`reject` exactly once.
    Several deduplicated client futures may ride one pending.
    """

    __slots__ = ("query", "spec", "workload", "cell", "fingerprint", "key",
                 "waiters", "enqueued_at", "done", "_engine")

    def __init__(self, engine: "WhatIfEngine", query: WhatIfQuery,
                 spec: ExperimentSpec, fingerprint: Dict, key: str,
                 enqueued_at: float) -> None:
        self._engine = engine
        self.query = query
        self.spec = spec
        self.workload = spec.workloads[0]
        self.cell = query.cell()
        self.fingerprint = fingerprint
        self.key = key
        self.waiters: List[Tuple[Future, int]] = []  # (future, t0_ns)
        self.enqueued_at = enqueued_at
        self.done = False

    def resolve(self, metrics: Dict[str, float]) -> None:
        self._engine._resolve_pending(self, metrics)

    def reject(self, exc: BaseException) -> None:
        self._engine._reject_pending(self, exc)


Executor = Callable[[List[_Pending]], None]


# ----------------------------------------------------------------------
# the engine
class WhatIfEngine:
    """Persistent what-if query service over the experiment cell store.

    ``base`` fixes everything a query does not override (workload set,
    trace scale/seed, transform, base scenario) and the engine
    (``torch`` | ``des``).  ``cache_dir`` enables the shared on-disk cell
    store; results are additionally memoized in process (``memo_limit``
    cells) so repeated queries skip even the store read.

    Admission: a miss enqueues (bounded by ``max_queue``; beyond it
    :meth:`submit` raises :class:`QueueFullError`).  The dispatcher
    drains up to ``max_batch`` queries per batch, waiting at most
    ``max_wait_s`` after the batch's *first* query for stragglers — the
    latency-vs-batch-width tradeoff knob (``docs/serving.md``).

    ``backend_options`` are the torch engine's results-neutral knobs
    (``device``, ``expand_backend``, ``window``, ``chunk``, ``events``,
    ``max_steps_factor``, ``chunk_lanes``, ``devices``; as
    :func:`repro_torch.experiments.backend_torch.run_cells` takes them,
    except that ``devices`` defaults to 1).

    ``executor`` computes one admitted batch (defaults to the engine's
    real executor); ``clock`` supplies time (defaults to the monotonic
    wall clock).  Both exist for the deterministic concurrency tests.
    ``start=False`` creates the engine paused — queries queue up and
    :meth:`start` launches the dispatcher — which tests (and batch CLIs
    that want maximum coalescing) use to make admission order exact.
    """

    def __init__(self, base: ExperimentSpec, *,
                 cache_dir: Optional[str] = None,
                 max_batch: int = 16,
                 max_wait_s: float = 0.005,
                 max_queue: int = 1024,
                 memo_limit: int = 4096,
                 backend_options: Optional[Dict] = None,
                 executor: Optional[Executor] = None,
                 clock: Optional[MonotonicClock] = None,
                 start: bool = True) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self.base = base
        self.engine = base.engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.memo_limit = memo_limit
        self.backend_options = dict(backend_options or {})
        self.store = SweepCache(cache_dir) if cache_dir else None
        self.device = None  # the torch executor's, set when it is chosen
        self._executor = executor or self._default_executor()
        self._clock = clock or MonotonicClock()
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._pending_by_key: Dict[str, _Pending] = {}
        self._memo: Dict[str, Dict[str, float]] = {}
        self._wl_memo: Dict[tuple, tuple] = {}
        self._closed = False
        self._stats = {"queries": 0, "memo_hits": 0, "store_hits": 0,
                       "misses": 0, "dedup": 0, "batches": 0,
                       "computed": 0, "failed": 0, "batch_widths": []}
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "WhatIfEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="whatif-dispatcher",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self, *, cancel_pending: bool = False,
              timeout: Optional[float] = 30.0) -> None:
        """Stop accepting queries; drain (default) or cancel the queue."""
        with self._cv:
            self._closed = True
            if cancel_pending:
                cancelled, self._queue = self._queue, []
            else:
                cancelled = []
            self._cv.notify_all()
        for p in cancelled:
            self._reject_pending(p, EngineClosedError(
                "engine closed before this query was dispatched"))
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "WhatIfEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel_pending=True)

    def kick(self) -> None:
        """Wake the dispatcher to re-check admission (fake clocks)."""
        with self._cv:
            self._cv.notify_all()

    # -- client API -----------------------------------------------------
    def submit(self, query: WhatIfQuery) -> "Future[Dict[str, float]]":
        """Async submit; the future resolves to the cell's metric dict."""
        spec = query.spec_for(self.base)
        workload = spec.workloads[0]
        fingerprint = spec.cell_fingerprint(workload, query.cell())
        key = SweepCache.key(fingerprint)
        t0_ns = time.monotonic_ns()
        fut: Future = Future()

        with self._cv:
            if self._closed:
                raise EngineClosedError("engine is closed")
            self._stats["queries"] += 1
            metrics = self._memo.get(key)
            if metrics is not None:
                self._stats["memo_hits"] += 1
                obs.counter("serve.hit")
                obs.counter("serve.memo_hit")
                self._finish(fut, t0_ns, metrics, path="memo")
                return fut
            pending = self._pending_by_key.get(key)
            if pending is not None:
                pending.waiters.append((fut, t0_ns))
                self._stats["dedup"] += 1
                obs.counter("serve.dedup")
                return fut

        # store read outside the lock: disk I/O must not block submitters
        if self.store is not None:
            metrics = self.store.get(fingerprint)
            if metrics is not None:
                with self._cv:
                    self._memoize(key, metrics)
                    self._stats["store_hits"] += 1
                obs.counter("serve.hit")
                obs.counter("serve.store_hit")
                self._finish(fut, t0_ns, metrics, path="store")
                return fut

        with self._cv:
            if self._closed:
                raise EngineClosedError("engine is closed")
            # re-check under the lock: the store read raced a resolve
            metrics = self._memo.get(key)
            if metrics is not None:
                self._stats["memo_hits"] += 1
                obs.counter("serve.hit")
                self._finish(fut, t0_ns, metrics, path="memo")
                return fut
            pending = self._pending_by_key.get(key)
            if pending is not None:
                pending.waiters.append((fut, t0_ns))
                self._stats["dedup"] += 1
                obs.counter("serve.dedup")
                return fut
            if len(self._queue) >= self.max_queue:
                obs.counter("serve.rejected")
                raise QueueFullError(
                    f"admission queue is full ({self.max_queue} queries)")
            pending = _Pending(self, query, spec, fingerprint, key,
                               self._clock.now())
            pending.waiters.append((fut, t0_ns))
            self._queue.append(pending)
            self._pending_by_key[key] = pending
            self._stats["misses"] += 1
            obs.counter("serve.miss")
            obs.gauge("serve.queue_depth", len(self._queue))
            self._cv.notify_all()
        return fut

    def query(self, query: WhatIfQuery, *,
              timeout: Optional[float] = None) -> Dict[str, float]:
        """Blocking submit; raises what the computation raised."""
        return self.submit(query).result(timeout)

    def stats(self) -> Dict:
        with self._cv:
            s = dict(self._stats)
            widths = s.pop("batch_widths")
            s["queue_depth"] = len(self._queue)
            s["hits"] = s["memo_hits"] + s["store_hits"]
            s["max_batch_width"] = max(widths, default=0)
            s["mean_batch_width"] = (sum(widths) / len(widths)
                                     if widths else 0.0)
            return s

    # -- dispatcher -----------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._execute(batch)

    def _next_batch(self) -> Optional[List[_Pending]]:
        with self._cv:
            while not self._queue:
                if self._closed:
                    return None
                self._clock.wait(self._cv, None)
            # admission: dispatch when the batch is full or the oldest
            # query has waited max_wait_s — whichever happens first
            deadline = self._queue[0].enqueued_at + self.max_wait_s
            while len(self._queue) < self.max_batch and not self._closed:
                remaining = deadline - self._clock.now()
                if remaining <= 0:
                    break
                self._clock.wait(self._cv, remaining)
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            obs.gauge("serve.queue_depth", len(self._queue))
            self._stats["batches"] += 1
            self._stats["batch_widths"].append(len(batch))
        obs.counter("serve.batches")
        obs.gauge("serve.coalesce_width", len(batch))
        return batch

    def _execute(self, batch: List[_Pending]) -> None:
        with obs.span("serve.batch", width=len(batch), engine=self.engine):
            try:
                self._executor(batch)
            except Exception as exc:  # noqa: BLE001 — per-query propagation
                for p in batch:
                    if not p.done:
                        self._reject_pending(p, exc)
        for p in batch:
            if not p.done:
                self._reject_pending(p, QueryFailedError(
                    "executor returned without resolving this query"))

    # -- resolution (also the executor-facing callbacks) ----------------
    def _finish(self, fut: Future, t0_ns: int, metrics: Dict[str, float],
                path: str) -> None:
        obs.record_span("serve.query", t0_ns, path=path)
        fut.set_result(metrics)

    def _memoize(self, key: str, metrics: Dict[str, float]) -> None:
        # caller holds self._cv; plain FIFO bound (insertion order)
        self._memo[key] = metrics
        while len(self._memo) > self.memo_limit:
            self._memo.pop(next(iter(self._memo)))

    def _resolve_pending(self, p: _Pending,
                         metrics: Dict[str, float]) -> None:
        if self.store is not None:
            self.store.put(p.fingerprint, metrics)
        with self._cv:
            if p.done:
                return
            p.done = True
            self._pending_by_key.pop(p.key, None)
            self._memoize(p.key, metrics)
            self._stats["computed"] += 1
            waiters = list(p.waiters)
        obs.counter("serve.computed")
        for fut, t0_ns in waiters:
            self._finish(fut, t0_ns, metrics, path="computed")

    def _reject_pending(self, p: _Pending, exc: BaseException) -> None:
        with self._cv:
            if p.done:
                return
            p.done = True
            self._pending_by_key.pop(p.key, None)
            self._stats["failed"] += 1
            waiters = list(p.waiters)
        obs.counter("serve.failed")
        wrapped = (exc if isinstance(exc, QueryFailedError) else
                   QueryFailedError(f"what-if query {p.query.to_dict()} "
                                    f"failed: {exc}"))
        wrapped.__cause__ = None if wrapped is exc else exc
        for fut, t0_ns in waiters:
            obs.record_span("serve.query", t0_ns, path="failed")
            fut.set_exception(wrapped)

    # -- real executors -------------------------------------------------
    def _default_executor(self) -> Executor:
        if self.engine == "des":
            return self._des_executor
        # resolved here, so an engine without a card raises when it is
        # made, to an indexed card, which the dispatcher thread makes its own
        self.device = resolve_device(self.backend_options.get("device"))
        if self.device.type == "cuda" and self.device.index is None:
            import torch
            self.device = torch.device("cuda", torch.cuda.current_device())
        return self._torch_executor

    def _des_executor(self, batch: List[_Pending]) -> None:
        """Reference path: each query through the numpy DES, streamed
        per cell (exactly :func:`backend_des.simulate_cell`, so served
        results are bit-identical to a DES ``run_experiment``)."""
        from repro_torch.experiments.backend_des import simulate_cell

        for p in batch:
            try:
                p.resolve(simulate_cell(p.spec, p.workload, p.cell))
            except Exception as exc:  # noqa: BLE001 — poison one query
                p.reject(exc)

    def _realized(self, spec: ExperimentSpec, name: str):
        """Workload realization memo.  ``backfill_depth`` / ``queue_order``
        are engine data, not trace transforms, so spec variants differing
        only there share one realization."""
        from repro_torch.core.scenario import DEFAULT_BACKFILL_DEPTH
        from repro_torch.experiments.spec import prepare_workload

        scen = dataclasses.replace(spec.scenario,
                                   backfill_depth=DEFAULT_BACKFILL_DEPTH,
                                   queue_order="fcfs").canonical()
        key = (name, spec.trace_seed, spec.scale, scen, spec.transform)
        if key not in self._wl_memo:
            if len(self._wl_memo) >= 8:  # bound resident traces
                self._wl_memo.pop(next(iter(self._wl_memo)))
            self._wl_memo[key] = prepare_workload(spec, name)
        return self._wl_memo[key]

    def _torch_executor(self, batch: List[_Pending]) -> None:
        """Coalesced path: every query is one padded lane of one device
        batch per pass structure; results stream back per chunk.

        Heterogeneity rides as lane data — workload, backfill depth and
        queue order are per-lane fields of :class:`BatchedLanes` — so the
        whole batch runs as one engine invocation per structure, with the
        metric recipe of :func:`backend_torch.run_cells`, so served cells
        are bit-identical to sweep cells.
        """
        import numpy as np
        import torch

        from repro_torch.core import DONE, get_strategy
        from repro_torch.experiments.backend_torch import (chunk_metrics,
                                                           engine_config)
        from repro_torch.sweep.batch import build_lanes, concat_lanes
        from repro_torch.sweep.shard import (ShardConfig,
                                             simulate_lanes_chunked)

        opts = self.backend_options
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # the dispatcher's launches
        groups: Dict[str, List[_Pending]] = {}
        for p in batch:
            groups.setdefault(get_strategy(p.cell[0]).structure,
                              []).append(p)
        for structure, group in groups.items():
            try:
                batches, t0s, t1s, caps = [], [], [], []
                for p in group:
                    cl, w_rigid, window = self._realized(p.spec, p.workload)
                    lanes = [(get_strategy(p.cell[0]), p.cell[1], p.cell[2])]
                    b, _order = build_lanes(
                        w_rigid, cl.nodes, lanes, config=p.spec.transform,
                        tick=cl.tick,
                        backfill_depth=p.spec.scenario.backfill_depth,
                        queue_order=p.spec.scenario.queue_order,
                        device=self.device)
                    batches.append(b)
                    t0s.append(window.t0)
                    t1s.append(window.t1)
                    caps.append(cl.nodes)
                big = concat_lanes(batches) if len(batches) > 1 else batches[0]
                shard = ShardConfig(
                    chunk_lanes=int(opts.get("chunk_lanes", 0)),
                    devices=int(opts.get("devices", 1) or 1))
                win0, win1 = np.asarray(t0s), np.asarray(t1s)
                caps_arr = np.asarray(caps)
                # one piece stays on the engine's card; a split takes
                # the cards the options name (cuda:0, cuda:1, ...)
                stream = simulate_lanes_chunked(
                    big, engine_config(structure, opts), shard,
                    device=(opts.get("device") if shard.devices > 1
                            else self.device))
                for ch in self._metered_chunks(stream):
                    per_lane = chunk_metrics(ch, big, win0, win1, caps_arr)
                    lane_done = np.all(ch.results["state"] == DONE, axis=1)
                    for p, m, ok in zip(group[ch.lo:ch.hi], per_lane,
                                        lane_done):
                        if bool(ok):
                            p.resolve(m)
                        else:
                            p.reject(QueryFailedError(
                                f"lane for {p.query.to_dict()} hit the "
                                "engine step budget before completing"))
            except Exception as exc:  # noqa: BLE001 — poison this group
                for p in group:
                    if not p.done:
                        p.reject(exc)

    @staticmethod
    def _metered_chunks(stream):
        for ch in stream:
            obs.counter("serve.chunks")
            obs.counter("serve.steps", int(ch.results["steps"]))
            yield ch
