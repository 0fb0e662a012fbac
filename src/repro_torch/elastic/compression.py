"""Int8 error-feedback gradient compression for data-parallel all-reduce:
the port of the JAX package's ``elastic/compression.py``.

Per-tensor symmetric int8 quantization with an error-feedback residual
(1-bit-Adam-style): the quantization error is carried to the next step, so
the compressed SGD trajectory tracks the exact one.  On a cluster the int8
payload is what crosses the data-parallel axis; here, on one device, the
step quantizes and dequantizes in place of that exchange.  Trees are keyed
by parameter name; a tensor is a JAX leaf, so the layers of a segment
(``segments.<i>.<layer>.<rest>``, stacked in the JAX tree) share one scale,
as in the reference.  Bit for bit the reference's arithmetic: f32,
rounding half to even.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.convert import jax_key

Params = Dict[str, torch.Tensor]


def init_residuals(params: Params) -> Params:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def _scale(xs) -> torch.Tensor:
    """One leaf's scale: its largest |x| (over the layers of a stack) /
    127."""
    amax = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xs]))
    return (amax + 1e-12) / 127.0


def _max_over(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    from repro_torch.launch.mesh import world_device_type
    buf = x.to(world_device_type(), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(x.device)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads: Params, residuals: Params, sharded=(),
                        group=None) -> Tuple[Params, Params]:
    """Quantize (grad + residual) to int8; return (dequantized, new
    residual), each keyed as ``grads``.

    The dequantized gradients are what the optimizer consumes; in a
    multi-device run the int8 tensors would be the all-reduce payload and
    dequantization would happen after the sum.  Under tensor parallelism
    the trees hold this rank's shards: a leaf whose tensors are named in
    ``sharded`` takes its largest |x| over ``group`` (the model group), so
    its scale is the whole leaf's.
    """
    leaves = {}
    for n in grads:
        leaves.setdefault(jax_key(n)[0], []).append(n)
    deq, res = {}, {}
    for names in leaves.values():
        g32 = {n: grads[n].to(torch.float32) + residuals[n] for n in names}
        scale = _scale(g32.values())
        if group is not None and names[0] in sharded:
            scale = _max_over(scale, group)
        for n, g in g32.items():
            deq[n] = _dequantize(_quantize(g, scale), scale)
            res[n] = g - deq[n]
    return deq, res
