"""Batched per-lane paper metrics, on the device of the engine's tensors.

The port of ``repro.sweep.metrics_jax.batched_metrics``, key-for-key: wait /
makespan / turnaround means and medians, utilization from the event-step
busy timeline (``busy[k]`` holds on ``[t[k], t[k+1])``), and
expand / shrink operations per malleable job, inside each lane's
measurement window.  Windows and capacities are per-lane data, so one call
covers a multi-workload batch; padding jobs (``submit = +inf``) fall
outside every window.  Float sums reduce in another order than XLA's, so
means and utilization agree with the JAX package to float32 rounding, not
bit for bit; medians and counts are exact.

The float sums are a fixed pairwise tree of elementwise adds over each
row's nonzero terms in order (:func:`_tree_sum`), not a reduction
kernel: a CUDA reduction's order follows the row's memory alignment, so a
lane's mean moved with its position in the batch, a CPU reduction's
order differs from a CUDA one's, and the busy timeline of the same
schedule holds its zero-width entries at other columns under another
chunk plan, step count or event compression.  With the tree, a cell's
metrics are the same bits at any lane position, under any plan, in any
coalesced what-if batch, on the card and on the CPU.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device

F32 = torch.float32


def _tree_sum(x):
    """Row sums of ``x`` (B, n) that depend on each row's nonzero terms in
    order and on nothing else: those move to the front (a stable sort),
    the rows are padded with zeros to a power of two, then halved by
    elementwise adds until one column is left (a zero added to a term
    leaves it as it was)."""
    keep = torch.argsort((x == 0).to(torch.int32), dim=-1, stable=True)
    x = torch.gather(x, -1, keep)
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _metrics_device(start, end, expand_ops, shrink_ops, submit, malleable,
                    trace_t, trace_busy, t0, t1, capacity):
    B = start.shape[0]
    done = torch.isfinite(end)
    in_win = (submit >= t0[:, None]) & (submit <= t1[:, None])
    sel = in_win & done
    n_sel = torch.sum(sel, dim=-1, dtype=torch.int32)
    some = torch.clamp(n_sel, min=1)
    nan = float("nan")

    wait = start - submit
    makespan = end - start
    turnaround = end - submit

    def mean(x):
        m = _tree_sum(torch.where(sel, x, 0.0)) / some
        return torch.where(n_sel > 0, m, nan)

    def p50(x):
        xs = torch.sort(torch.where(sel, x, float("inf")), dim=-1).values
        i1 = torch.clamp(torch.div(n_sel - 1, 2, rounding_mode="floor"),
                         min=0)
        i2 = torch.clamp(torch.div(n_sel, 2, rounding_mode="floor"),
                         max=xs.shape[-1] - 1)
        v1 = torch.gather(xs, 1, i1[:, None].long())[:, 0]
        v2 = torch.gather(xs, 1, i2[:, None].long())[:, 0]
        return torch.where(n_sel > 0, 0.5 * (v1 + v2), nan)

    # busy integral over the window from the event timeline
    t_next = torch.cat([trace_t[:, 1:],
                        torch.full((B, 1), float("inf"), dtype=trace_t.dtype,
                                   device=trace_t.device)], dim=-1)
    seg = torch.clamp(torch.minimum(t_next, t1[:, None])
                      - torch.maximum(trace_t, t0[:, None]), min=0.0)
    integral = _tree_sum(trace_busy.to(F32) * seg)
    util = integral / (capacity * torch.clamp(t1 - t0, min=1e-9))

    msel = sel & malleable
    n_mall = torch.sum(msel, dim=-1, dtype=torch.int32)
    mall_some = torch.clamp(n_mall, min=1)
    expand = torch.sum(torch.where(msel, expand_ops, 0), dim=-1,
                       dtype=torch.int32) / mall_some
    shrink = torch.sum(torch.where(msel, shrink_ops, 0), dim=-1,
                       dtype=torch.int32) / mall_some

    return {
        "n_jobs": n_sel.to(F32),
        "n_malleable": n_mall.to(F32),
        "wait_mean": mean(wait),
        "wait_p50": p50(wait),
        "makespan_mean": mean(makespan),
        "turnaround_mean": mean(turnaround),
        "turnaround_p50": p50(turnaround),
        "utilization": util,
        "expand_per_job": expand.to(F32),
        "shrink_per_job": shrink.to(F32),
        "unfinished": torch.sum(in_win & ~done, dim=-1).to(F32),
    }


@torch.inference_mode()
def batched_metrics(result: Dict[str, np.ndarray], submit, malleable,
                    window, capacity, device=None) -> List[Dict[str, float]]:
    """Per-lane metric dicts for a :func:`simulate_lanes` result.

    ``submit`` ((n,) or (B, n)) and ``malleable`` (B, n) are in the engine's
    submit-sorted job order.  ``window`` is a
    :class:`~repro_torch.core.metrics.Window` shared by every lane or a
    ``(t0, t1)`` pair of per-lane arrays; ``capacity`` is a shared int or a
    per-lane array.  Runs on the device of ``malleable`` when it is a
    tensor, else on ``device`` (cuda by default).
    """
    dev = (malleable.device if torch.is_tensor(malleable)
           else resolve_device(device))

    def t(a, dtype=None):
        a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                            device=dev)
        return a if dtype is None else a.to(dtype)

    mall = t(malleable, torch.bool)
    B = mall.shape[0]
    sub = t(submit, F32)
    if sub.ndim == 1:
        sub = sub.expand(B, sub.shape[0])
    if hasattr(window, "t0"):
        t0, t1 = window.t0, window.t1
    else:
        t0, t1 = window
    t0 = t(t0, F32).expand(B)
    t1 = t(t1, F32).expand(B)
    cap = t(capacity, F32).expand(B)
    dev_out = _metrics_device(
        t(result["start_t"]), t(result["end_t"]), t(result["expand_ops"]),
        t(result["shrink_ops"]), sub, mall, t(result["trace_t"]),
        t(result["trace_busy"]), t0, t1, cap)
    host = {k: v.cpu().numpy() for k, v in dev_out.items()}
    return [{k: float(host[k][b]) for k in host} for b in range(B)]
