"""The port's ``forward_train`` and its gradients against the JAX package,
on the CPU, for every registered architecture's reduced config.

The JAX ``init_params(jax.random.key(0), cfg)`` weights cross into the port
with ``lm_params_from_numpy``; one ``batch_for`` batch (2 x 32; vision
patches and whisper's frames included) goes through the JAX
``jax.value_and_grad(forward_train)`` and through the port's
``forward_train`` + ``backward()`` (RMSNorm's and attention's autograd
functions take their plain backward versions on the CPU; the SSD scan is
differentiated as plain ops), both in f32.  The loss, ``ce_loss`` and
``aux_loss`` must agree within 2e-5 (relative), and every parameter's
gradient, gathered into the JAX layout by ``lm_params_to_numpy(grad=True)``,
within 1e-4 of the largest |gradient| of its leaf: f32 sums taken in other
orders, over a few hundred terms.  The architectures are split between
this file and ``test_torch_train_families.py`` so that the test workers
share them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models.transformer import forward_train as jax_forward  # noqa
from repro.models.transformer import init_params  # noqa: E402
from repro.train.data import batch_for  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, to_tensors)
from repro_torch.models import transformer as T  # noqa: E402

LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4

ARCHS = ["stablelm-1.6b", "gemma3-4b", "glm4-9b", "qwen2-72b",
         "internvl2-2b"]


def flat_tree(tree):
    """A JAX pytree as numpy arrays keyed by their ``/``-joined paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                               None)))
                 for k in path]
        out["/".join(map(str, names))] = np.asarray(leaf)
    return out


def check_forward_train(arch, remat="dots"):
    """JAX and the port on the same weights and batch: loss, metrics and
    every gradient."""
    cfg = get_config(arch).reduced()
    params = init_params(jax.random.key(0), cfg)
    batch = batch_for(cfg, 32, 2, step=1, seed=0)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_forward(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              dtype=jnp.float32, remat="none"),
        has_aux=True)(params)
    model = lm_params_from_numpy(flat_tree(params), cfg, "cpu")
    model.requires_grad_(True)
    loss, metrics = T.forward_train(model, cfg, to_tensors(batch, "cpu"),
                                    dtype=torch.float32, remat=remat)
    loss.backward()
    for got, exp in ((loss.detach(), jloss),
                     (metrics["ce_loss"].detach(), jm["ce_loss"]),
                     (metrics["aux_loss"].detach(), jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(exp), rtol=LOSS_RTOL,
                                   atol=1e-7)
    got, exp = lm_params_to_numpy(model, cfg, grad=True), flat_tree(jgrads)
    assert sorted(got) == sorted(exp)
    for key in exp:
        assert got[key].shape == exp[key].shape, key
        scale = float(np.abs(exp[key]).max())
        np.testing.assert_allclose(got[key], exp[key], rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-6),
                                   err_msg=key)
    return cfg, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_gradients_match_jax(arch):
    check_forward_train(arch)
