"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``csrc/schedule_tick.cu`` (the fused greedy scheduling pass),
``csrc/waterfill.cu`` (the prefix waterfill), ``csrc/rmsnorm.cu``,
``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` (the LLM layer's
RMSNorm, online-softmax attention and Mamba-2 SSD scan) are built by
:mod:`.build` at their first launch; :mod:`.ref` holds the plain versions
the CPU tests use and the card is checked against.

The package exports the JAX package's kernel names under the port's:
``waterfill``, ``fused_schedule_tick``, ``rmsnorm``, ``flash_attention``,
``ssd_scan``, ``greedy_shrink_waterfill`` / ``greedy_expand_waterfill``
(the reference's ``greedy_shrink_pallas`` / ``greedy_expand_pallas``) and
``ref``.  They resolve lazily (PEP 562), so importing the package imports
no wrapper and builds nothing.  Four wrappers share their module's name,
and Python binds a package's imported submodule to that name, so each of
those modules is a :class:`KernelModule`: calling it calls its wrapper
(``repro_torch.kernels.waterfill(cap, target)``), while its other names
stay attributes (``repro_torch.kernels.waterfill.plan``).

The reference's ``ops`` (TPU / XLA dispatch) has no module here: each
wrapper dispatches on its tensor's device, launching its kernel on
``cuda`` and taking its plain version on the CPU.
"""
import importlib
import types
from typing import TYPE_CHECKING

_EXPORTS = {
    "waterfill": "waterfill", "greedy_shrink_waterfill": "waterfill",
    "greedy_expand_waterfill": "waterfill",
    "fused_schedule_tick": "schedule_tick", "rmsnorm": "rmsnorm",
    "flash_attention": "flash_attention", "ssd_scan": "ssd_scan",
}

__all__ = sorted([*_EXPORTS, "ref"])

if TYPE_CHECKING:  # pragma: no cover
    from . import ref
    from .flash_attention import flash_attention
    from .rmsnorm import rmsnorm
    from .schedule_tick import fused_schedule_tick
    from .ssd_scan import ssd_scan
    from .waterfill import (greedy_expand_waterfill, greedy_shrink_waterfill,
                            waterfill)


class KernelModule(types.ModuleType):
    """A kernel's module that is also its wrapper: calling it calls the
    module's function of the same name."""

    def __call__(self, *args, **kwargs):
        return getattr(self, self.__name__.rpartition(".")[2])(*args,
                                                                **kwargs)


def __dir__():
    return sorted(set(globals()) | set(__all__))


def __getattr__(name):
    if name == "ref":
        return importlib.import_module(".ref", __name__)
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(f".{module}", __name__)
    # a wrapper named as its module: the module, which calls it
    return mod if module == name else getattr(mod, name)
