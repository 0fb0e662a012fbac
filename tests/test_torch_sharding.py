"""The port's sharding rules and meshes against the JAX package's, on the
CPU, from shapes alone (nothing is allocated).

* ``param_specs``: every leaf of every registered arch's published config,
  the JAX leaves from ``jax.eval_shape(init_params)`` and the port's from
  an LM on the ``meta`` device stacked per ``convert.jax_key``, on the
  reference's fake 16 x 16 ``(data, model)`` and 2 x 16 x 16 ``(pod,
  data, model)`` meshes, with ``fsdp`` on and off: the same paths and the
  same specs;
* ``cache_specs`` over every arch's decode cache, ``batch_spec``,
  ``default_policy``, ``dp_axes`` / ``dp_size``: equal;
* the port's own: a tensor's spec is its stacked leaf's without the layer
  axis, a row of a stack sharded on its layer axis is replicated, specs
  become ``Shard`` / ``Replicate`` placements, and the production mesh
  needs 256 / 512 ranks.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, list_archs  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import sharding as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import sharding as TSH  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

ARCHS = list_archs()


class SinglePod:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class MultiPod:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": SinglePod, "2x16x16": MultiPod}


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", getattr(
        entry, "name", entry)))


def _jax_specs(tree, mesh, fsdp):
    specs = JSH.param_specs(tree, mesh, fsdp=fsdp,
                            dp_axes=JMESH.dp_axes(mesh))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(_key(k)) for k in path): tuple(spec)
            for path, spec in flat[0]}


@pytest.fixture(scope="module")
def jax_shapes():
    return {arch: jax.eval_shape(lambda a=arch: JT.init_params(
        jax.random.key(0), get_config(a))) for arch in ARCHS}


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh, fsdp, jax_shapes):
    fake = MESHES[mesh]
    want = _jax_specs(jax_shapes[arch], fake, fsdp)
    model = LM(t_config(arch), "meta")
    got = TSH.param_specs(model, fake, fsdp=fsdp,
                          dp_axes=TMESH.dp_axes(fake))
    assert sorted(got) == sorted(want)
    assert got == want
    shapes = TSH.stacked_shapes(model)
    flat = {"/".join(str(_key(k)) for k in p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jax_shapes[arch])[0]}
    assert shapes == flat


def _port_cache_specs(tree):
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        elif isinstance(node, list) or hasattr(node, "_fields"):
            names = getattr(node, "_fields", range(len(node)))
            for k, v in zip(names, node):
                walk(v, prefix + (str(k),))
        else:
            out["/".join(prefix)] = node
    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    fake = MESHES[mesh]
    for batch in (32, 8):
        cache_j = jax.eval_shape(lambda: JD.init_decode_cache(
            get_config(arch), batch, 64, jnp.bfloat16, enc_len=24))
        flat = jax.tree_util.tree_flatten_with_path(
            JSH.cache_specs(cache_j, fake),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {"/".join(str(_key(k)) for k in p): tuple(s)
                for p, s in flat[0]}
        cache_t = TD.init_decode_cache(t_config(arch), batch, 64,
                                       device="meta", enc_len=24)
        got = _port_cache_specs(TSH.cache_specs(cache_t, fake))
        assert got == want, batch


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_dp_axes_match_the_reference(mesh):
    fake = MESHES[mesh]
    assert TSH.batch_spec(fake) == tuple(JSH.batch_spec(fake))
    assert TMESH.dp_axes(fake) == JMESH.dp_axes(fake)
    assert TMESH.dp_size(fake) == JMESH.dp_size(fake)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_policy_matches_the_reference(arch):
    assert dataclasses.asdict(TMESH.default_policy(arch)) == \
        dataclasses.asdict(JMESH.default_policy(arch))
    assert (TMESH._BIG, TMESH._SMALL) == (JMESH._BIG, JMESH._SMALL)


def test_spec_for_param_cases_of_the_reference():
    """The reference's own cases (``tests/test_distribution.py``)."""
    assert TSH.spec_for_param("mlp/w1", (8192, 29568), SinglePod) == \
        (None, "model")
    assert TSH.spec_for_param("mlp/w1", (8192, 1030), SinglePod) == \
        (None, None)
    cache = {"segments": [{"ckv": torch.empty(60, 128, 4096, 512,
                                              device="meta"),
                           "krope": torch.empty(60, 128, 4096, 64,
                                                device="meta")}]}
    ckv = TSH.cache_specs(cache, SinglePod)["segments"][0]["ckv"]
    assert ckv[1] == "data" and ckv[3] == "model" and ckv[2] is None


def _mini():
    return dataclasses.replace(t_config("stablelm-1.6b").reduced(),
                               n_layers=2, d_model=64, d_ff=128, vocab=256,
                               name="mini")


class DataTwo:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 1}


def test_tensor_specs_drop_the_layer_axis_and_refuse_to_shard_it():
    model = LM(_mini(), "meta")
    stacked = TSH.param_specs(model, SinglePod)
    per_tensor = TSH.tensor_specs({"params": model}, SinglePod)
    for name, p in model.named_parameters():
        path, layer = TSH._jax_path((name,))
        spec = per_tensor[f"params/{name}"]
        assert len(spec) == p.dim(), name
        assert spec == (stacked[path][1:] if layer is not None
                        else stacked[path])
    # fsdp over data = 2 shards a 2-layer stack's norm scale (2, 64) on its
    # layer axis: the reference's spec, which no port tensor can take, so
    # each layer's row is replicated
    assert TSH.param_specs(model, DataTwo, fsdp=True)[
        "segments/0/ln1/scale"] == ("data", None)
    fsdp = TSH.tensor_specs(model, DataTwo, fsdp=True)
    assert fsdp["segments.0.0.ln1.scale"] == (None,)
    assert TSH.is_replicated(fsdp["segments.0.1.ln1.scale"], DataTwo)
    # a MoE block's shared-expert stack (L, d, ff) reads as experts: at
    # model 2 its 2-layer stack is sharded on the layer axis, a row whole
    moe = LM(dataclasses.replace(_mini(), n_experts=4, top_k=2,
                                 moe_d_ff=32, n_shared_experts=1), "meta")
    model_two = type("ModelTwo", (), {"axis_names": ("data", "model"),
                                      "shape": {"data": 1, "model": 2}})
    assert TSH.param_specs(moe, model_two)[
        "segments/0/moe/shared/w1"] == ("model", None, None)
    assert TSH.tensor_specs(moe, model_two)[
        "segments.0.0.moe.shared.w1"] == (None, None)
    # without fsdp, a (data, 1) mesh replicates every tensor
    assert all(TSH.is_replicated(s, DataTwo) for s in
               TSH.tensor_specs(model, DataTwo).values())


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert TSH.placements(("data", "model"), SinglePod) == (Shard(0),
                                                             Shard(1))
    assert TSH.placements((None, "model"), SinglePod) == (Replicate(),
                                                          Shard(1))
    assert TSH.placements((("pod", "data"), None), MultiPod) == (
        Shard(0), Shard(0), Replicate())
    assert TSH.placements((None,), SinglePod) == (Replicate(), Replicate())
    assert TSH.is_replicated((None, "model"), DataTwo)
    assert not TSH.is_replicated(("data", None), DataTwo)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_a_pod_of_ranks(multi_pod):
    with pytest.raises(RuntimeError, match="256" if not multi_pod else "512"):
        TMESH.make_production_mesh(multi_pod=multi_pod)
