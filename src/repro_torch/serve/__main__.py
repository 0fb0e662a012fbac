"""What-if scheduling service CLI: ``python -m repro_torch.serve``.

The port of ``python -m repro.serve``: one-shot query storms (CI,
scripting) and a persistent HTTP mode, both in front of the same
:class:`repro_torch.serve.whatif.WhatIfEngine`.  ``--engine torch`` (the
default) answers misses on the batched engine on ``cuda`` unless
``--device cpu`` is given; ``--engine des`` runs the numpy DES on the
host.  ``--cache-dir`` defaults to none.

Examples::

  # one query, straight to stdout
  python -m repro_torch.serve --workload haswell --scale 0.01 --seeds 2 \\
      --query strategy=min,proportion=0.5

  # 16 random queries from 4 client threads against a shared store
  python -m repro_torch.serve --workload haswell --scale 0.01 --seeds 2 \\
      --random 16 --clients 4 --cache-dir /tmp/w

  # the rerun must be answered 100% from the store
  python -m repro_torch.serve ... --random 16 --clients 4 \\
      --cache-dir /tmp/w --expect-hits

  # persistent HTTP service: POST /whatif {"strategy": "avg", ...}
  python -m repro_torch.serve --workload haswell --http --port 8642
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import List

from repro_torch.experiments.cli import (add_execution_arguments,
                                         add_observability_arguments,
                                         add_scenario_arguments,
                                         configure_observability,
                                         execution_options_from_args,
                                         flush_observability,
                                         scenario_from_args)
from repro_torch.experiments.spec import ENGINES, ExperimentSpec

from .whatif import WhatIfEngine, WhatIfQuery, sample_queries


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core import CLUSTERS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, nargs="+",
                    choices=sorted(CLUSTERS),
                    help="workload(s) the service holds realized; queries "
                         "name one (default: the first)")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=2,
                    help="transform seeds admissible in queries")
    ap.add_argument("--engine", choices=list(ENGINES), default="torch",
                    help="torch: misses on the batched engine on the card "
                         "(default); des: the numpy DES on the host")
    add_scenario_arguments(ap)

    g = ap.add_argument_group("service")
    g.add_argument("--cache-dir", default="",
                   help="shared per-cell result store ('' = none)")
    g.add_argument("--max-batch", type=int, default=16,
                   help="coalescing width cap per dispatched batch")
    g.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time the dispatcher holds a batch open for "
                        "stragglers (latency-vs-width knob)")
    g.add_argument("--max-queue", type=int, default=1024,
                   help="bounded admission queue; beyond it submits fail")

    g = ap.add_argument_group("one-shot query storm")
    g.add_argument("--query", action="append", default=[],
                   metavar="K=V,K=V",
                   help="a what-if query, e.g. "
                        "strategy=avg,proportion=0.5,backfill_depth=4 "
                        "(repeatable)")
    g.add_argument("--random", type=int, default=0, metavar="N",
                   help="append N seeded random queries (storms)")
    g.add_argument("--query-seed", type=int, default=0,
                   help="seed for --random query sampling")
    g.add_argument("--clients", type=int, default=1,
                   help="submit from N concurrent client threads")
    g.add_argument("--expect-hits", action="store_true",
                   help="exit non-zero unless every query was a cache hit "
                        "(CI store-resume gate)")
    g.add_argument("--out", default="",
                   help="write per-query results as JSON")

    g = ap.add_argument_group("http mode")
    g.add_argument("--http", action="store_true",
                   help="serve HTTP instead of a one-shot storm: "
                        "POST /whatif, GET /stats, GET /healthz")
    g.add_argument("--port", type=int, default=8642)
    g.add_argument("--host", default="127.0.0.1")

    add_execution_arguments(ap)
    add_observability_arguments(ap)
    return ap


def base_spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    return ExperimentSpec(
        workloads=tuple(args.workload), scale=args.scale,
        trace_seed=args.trace_seed, seeds=args.seeds, engine=args.engine,
        scenario=scenario_from_args(args))


def engine_from_args(args: argparse.Namespace) -> WhatIfEngine:
    backend_options = execution_options_from_args(args)
    backend_options["devices"] = args.devices or 1
    return WhatIfEngine(
        base_spec_from_args(args),
        cache_dir=args.cache_dir or None,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0,
        max_queue=args.max_queue,
        backend_options=backend_options,
        start=False)


def run_storm(engine: WhatIfEngine, queries: List[WhatIfQuery],
              clients: int) -> List[dict]:
    """Submit ``queries`` from ``clients`` threads; return result rows."""
    rows = [None] * len(queries)
    lanes = [list(range(i, len(queries), clients)) for i in range(clients)]

    def client(idxs: List[int]) -> None:
        futs = [(i, engine.submit(queries[i])) for i in idxs]
        for i, fut in futs:
            row = {"query": queries[i].to_dict()}
            try:
                row["metrics"] = fut.result(timeout=600)
            except Exception as exc:  # noqa: BLE001 — report per query
                row["error"] = str(exc)
            rows[i] = row

    threads = [threading.Thread(target=client, args=(idxs,))
               for idxs in lanes if idxs]
    for t in threads:
        t.start()
    engine.start()
    for t in threads:
        t.join()
    return rows


def serve_http(engine: WhatIfEngine, host: str, port: int,
               started=None) -> int:
    """Blocking stdlib HTTP front-end: ``POST /whatif`` (a query's JSON
    fields; 400 on a bad query), ``GET /stats``, ``GET /healthz``.  The
    handler threads only submit and wait; the engine's dispatcher does
    every device operation.

    ``started``, when given, is called with the bound server before it
    serves: a caller running this in a thread reads the port (``port=0``
    binds a free one) and ends the service with ``shutdown()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, engine.stats())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self) -> None:  # noqa: N802 — http.server API
            if self.path != "/whatif":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                query = WhatIfQuery.from_dict(payload)
            except (ValueError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
                return
            try:
                metrics = engine.query(query, timeout=600)
            except Exception as exc:  # noqa: BLE001 — per-query errors
                self._send(500, {"error": str(exc),
                                 "query": query.to_dict()})
                return
            self._send(200, {"query": query.to_dict(), "metrics": metrics})

        def log_message(self, fmt, *a):  # quiet: obs has the counters
            pass

    engine.start()
    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"[serve] what-if service on http://{host}:"
          f"{httpd.server_address[1]} (engine={engine.engine}, "
          "POST /whatif, GET /stats)")
    try:
        if started is not None:
            started(httpd)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close(cancel_pending=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_observability(args)
    engine = engine_from_args(args)

    if args.http:
        return serve_http(engine, args.host, args.port)

    queries = [WhatIfQuery.parse(q) for q in args.query]
    if args.random:
        queries += sample_queries(
            args.query_seed, args.random, workloads=args.workload,
            seeds=args.seeds)
    if not queries:
        print("nothing to do: give --query/--random (or --http)",
              file=sys.stderr)
        return 2

    rows = run_storm(engine, queries, max(1, args.clients))
    stats = engine.stats()
    engine.close()
    failed = [r for r in rows if "error" in r]
    print(f"[serve] {len(rows)} queries: {stats['hits']} hits "
          f"({stats['memo_hits']} memo / {stats['store_hits']} store), "
          f"{stats['misses']} misses in {stats['batches']} batch(es) "
          f"(max width {stats['max_batch_width']}), "
          f"{stats['dedup']} deduped, {len(failed)} failed")
    if args.out:
        import pathlib

        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"stats": stats, "results": rows},
                                indent=2, sort_keys=True))
        print(f"[serve] wrote {args.out}")
    flush_observability(args)
    if failed:
        for r in failed[:5]:
            print(f"[serve] FAILED {r['query']}: {r['error']}",
                  file=sys.stderr)
        return 1
    if args.expect_hits and stats["misses"]:
        print(f"[serve] --expect-hits: {stats['misses']} queries missed "
              "the store", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
