"""PyTorch / CUDA port of the malleable-scheduling reproduction.

A second package beside the JAX reference ``repro``: it runs the paper grid
(the batched event-stepped engine, its metrics, chunked and card-split
lane execution in ``sweep.shard``, and the experiment layer,
``python -m repro_torch.experiments``), the what-if scheduling query
service (``serve.whatif``, ``python -m repro_torch.serve``), LLM serving
(``serve.engine`` over ``models``: the ``mamba``, ``shared``, ``attn``,
``moe``, ``enc`` and ``dec`` block kinds, GQA or MLA attention) and LLM
training (``train``, ``python -m repro_torch.launch.train``) in PyTorch,
with the greedy scheduling pass, the prefix waterfill, RMSNorm, flash
attention and the Mamba-2 SSD scan as hand-written CUDA kernels for Hopper
(``repro_torch/kernels/csrc``), and RMSNorm's and attention's gradients as
hand-written backward kernels (the SSD scan has none yet, so Mamba-2
blocks train on the CPU only).  It imports ``torch`` and numpy only; the
JAX package is never imported here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise instead of running on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present, so a CPU-only box never runs the port silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
