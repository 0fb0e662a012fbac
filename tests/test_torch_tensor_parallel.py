"""The port's tensor-parallel forward and training (``repro_torch.models.tp``)
against the port's single-device path and the JAX package, on the CPU.

* the plan (:func:`repro_torch.models.tp.tp_plan`) of every registered
  arch, published and reduced, at model 2, 4 and 8 on a ``MeshView`` (no
  world): each block's mode agrees with the partition rules' specs
  (``heads`` where the specs split on head boundaries, ``kv_gather`` /
  ``whole`` where one splits a head), and the named cases: glm4-9b's two
  kv heads and reduced glm4's at model 4, whisper's 20 heads at model 8,
  internvl2's vocab never split, whisper's split at 2, not at 4;
* a gloo world of 2 CPU processes, a ``(1, 2)`` mesh: the reduced forward
  of every arch placed by ``reshard_tree`` within ``FWD_TOL`` (5e-3, the
  reference test's) of the port's single-device forward; olmoe, glm4,
  mamba2 and zamba2 (the reference test's four, capacity factor 64) also
  within 5e-3 of the JAX single-device ``forward_logits`` on the same
  weights; one ``forward_train`` of several archs (every remat mode): the
  loss within 1e-5 and every gradient within ``GRAD_TOL`` of its leaf's
  largest |gradient| on one rank; ``apply_moe_sharded``'s train / prefill
  layout within 1e-5 of the JAX ``_apply_moe_local``;
* a gloo world of 4, ``(data 2, model 2)``: ``ElasticTrainer(model_parallel
  = 2)`` through the resize schedule (meshes (1, 2), (2, 2), (1, 2))
  follows a width-1, model-1 trainer (losses within 1e-5, the state within
  ``STATE_TOL``); its checkpoint reads back bit for bit in the JAX package
  and in a fresh model-2 trainer, whose next loss equals the running
  one's; a failure restore at width 1 keeps model 2; ``apply_moe_sharded``
  in its decode layout (S = 1, ``ff`` over ``data``) and its train layout
  (the batch over ``data``) within 1e-5 of the JAX ``_apply_moe_local``;
* a gloo world of 4, ``(1, 4)``: reduced glm4 with each kv head split in
  half (``kv_gather``), a glm4 whose one kv head of 18 columns the rules
  leave whole (``kv_gather`` from a replicated ``wk``), a 6-head glm4
  (``whole`` attention), a 2-head Mamba-2 (``whole`` SSM), a 6-head
  whisper (``whole`` self- and cross-attention), olmoe (2 experts a rank) and MLA with a replicated
  ``wkv_a``: the forward within 5e-3 and the gradients within
  ``GRAD_TOL`` of one rank's;
* ``make_lane_mesh`` / ``lane_sharding`` / ``shard_lanes`` in-process:
  the pieces are ``take_lanes`` of equal contiguous ranges, each on its
  device, and their runs equal the whole batch's bit for bit.

Each world has its own time limit and the workers' collective timeout
(``torch_dp_worker.COLLECTIVE_TIMEOUT_S``): a lost peer fails a test.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_worker as TPW  # noqa: E402
from test_torch_elastic import spawn_world  # noqa: E402
from test_torch_shard import _batch, _cfg  # noqa: E402
from test_torch_train_grads import flat_tree  # noqa: E402
from test_torch_train_step import STATE_TOL, _jax_tree  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.elastic import checkpoint as JCK  # noqa: E402
from repro.launch.mesh import make_lane_mesh as j_lane_mesh  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro.train.data import batch_for as j_batch_for  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.mesh import MeshView, make_lane_mesh  # noqa: E402
from repro_torch.models import tp  # noqa: E402
from repro_torch.models.sharding import tensor_specs  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.sweep import shard  # noqa: E402
from repro_torch.sweep.batch import (lane_statics, pad_lanes,  # noqa: E402
                                     simulate_lanes, take_lanes)

FWD_TOL = 5e-3      # tests/test_distribution.py's bound
GRAD_TOL = 2e-4     # of each leaf's largest |gradient| on one rank
MOE_TOL = 1e-5
WORLD_TIMEOUT_S = 200

JAX_ARCHS = ("olmoe-1b-7b", "glm4-9b", "mamba2-1.3b", "zamba2-2.7b")
FWD_2 = {arch: (arch, None) for arch in (
    "olmoe-1b-7b", "glm4-9b", "mamba2-1.3b", "zamba2-2.7b", "stablelm-1.6b",
    "gemma3-4b", "qwen2-72b", "internvl2-2b", "whisper-large-v3",
    "deepseek-v2-236b")}
GRAD_2 = {"mamba2-1.3b": ("mamba2-1.3b", None, "dots"),
          "zamba2-2.7b": ("zamba2-2.7b", None, "dots"),
          "whisper-large-v3": ("whisper-large-v3", None, "dots"),
          "olmoe-1b-7b": ("olmoe-1b-7b", None, "dots"),
          "gemma3-4b": ("gemma3-4b", None, "none"),
          "glm4-9b": ("glm4-9b", None, "full"),
          "internvl2-2b": ("internvl2-2b", None, "dots"),
          "deepseek-v2-236b": ("deepseek-v2-236b", None, "none")}
# model 4: (config, overrides) and the mode each one exercises
FWD_4 = {"glm4 kv split": ("glm4-9b", None),
         "glm4 wk replicated": ("glm4-9b", dict(n_heads=4, n_kv_heads=1,
                                                head_dim=18)),
         "glm4 6 heads": ("glm4-9b", dict(n_heads=6)),
         "mamba2 2 heads": ("mamba2-1.3b", dict(ssm_headdim=128)),
         "whisper 6 heads": ("whisper-large-v3",
                             dict(n_heads=6, n_kv_heads=6)),
         "olmoe": ("olmoe-1b-7b", None),
         "deepseek wkv_a replicated": ("deepseek-v2-236b", dict(kv_lora=34))}
MODES_4 = {"glm4 kv split": ("attn", "attn", "kv_gather"),
           "glm4 wk replicated": ("attn", "attn", "kv_gather"),
           "glm4 6 heads": ("attn", "attn", "whole"),
           "mamba2 2 heads": ("mamba", "ssm", "whole"),
           "whisper 6 heads": ("dec", "cross", "whole"),
           "olmoe": ("moe", "ffn", "experts"),
           "deepseek wkv_a replicated": ("moe", "attn", "heads")}
GRAD_4 = {name: FWD_4[name] + ("dots",) for name in (
    "glm4 kv split", "glm4 wk replicated", "glm4 6 heads", "mamba2 2 heads",
    "whisper 6 heads")}


# ------------------------------------------------------------ the plan
def _view(model):
    return MeshView(("data", "model"), {"data": 1, "model": model})


def _sharded(specs, name):
    return any(e == "model" for e in specs[name])


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("size", ["published", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_plan_agrees_with_the_partition_rules(arch, size, model):
    cfg = get_config(arch)
    if size == "reduced":
        cfg = cfg.reduced()
    plan = tp.tp_plan(cfg, _view(model))
    lm = LM(cfg, "meta")
    specs = tensor_specs(lm, _view(model))
    assert plan.model == model
    assert plan.vocab == _sharded(specs, "embed.table")
    if hasattr(lm, "unembed"):
        assert plan.vocab == _sharded(specs, "unembed")
    blocks = [(seg.kind, f"segments.{i}.{j}.")
              for i, (seg, layers) in enumerate(zip(lm.plan, lm.segments))
              for j in range(len(layers))]
    if cfg.shared_attn_every:
        blocks.append(("shared", "shared_block."))
    if cfg.is_encdec:
        blocks.append(("enc", "enc_segments.0.0."))
    assert sorted({k for k, _ in blocks}) == sorted(plan.blocks)
    for kind, pre in blocks:
        bp = plan.blocks[kind]
        if kind == "mamba":
            split = [_sharded(specs, pre + "mixer." + n)
                     for n in ("in_x", "in_dt", "out_proj")]
            assert bp.ssm == ("heads" if all(split) else "whole"), pre
            continue
        attn = pre + "attn."
        if cfg.attn == "mla" and kind in ("attn", "moe"):
            assert bp.attn == ("heads" if cfg.n_heads % model == 0
                               else "whole")
            if bp.attn == "heads":
                assert all(_sharded(specs, attn + n)
                           for n in ("wq_b", "wk_b", "wv_b", "wo"))
        else:
            q, k = _sharded(specs, attn + "wq"), _sharded(specs, attn + "wk")
            want = {"heads": cfg.n_heads % model == 0
                    and cfg.n_kv_heads % model == 0,
                    "kv_gather": cfg.n_heads % model == 0
                    and cfg.n_kv_heads % model != 0}
            assert bp.attn == next((m for m, ok in want.items() if ok),
                                   "whole"), pre
            if bp.attn in ("heads", "kv_gather"):
                assert q and _sharded(specs, attn + "wo")
            if bp.attn == "heads":
                assert k
        if kind == "moe":
            assert bp.ffn == ("experts" if _sharded(specs, pre + "moe.w1")
                              else "plain")
            if cfg.n_shared_experts:
                assert bp.shared == "plain"
                assert not _sharded(specs, pre + "moe.shared.w1")
        else:
            assert bp.ffn == ("columns" if _sharded(specs, pre + "mlp.w1")
                              else "plain")
            assert (bp.ffn == "columns") == _sharded(specs, pre + "mlp.w2")
        if kind == "dec":
            assert bp.cross == tp.attn_mode(cfg.n_heads, cfg.n_heads,
                                            cfg.head_dim, model)


def test_plan_names_the_head_splitting_cases():
    plan = tp.tp_plan
    for cfg in (get_config("glm4-9b"), get_config("glm4-9b").reduced()):
        assert plan(cfg, _view(4)).blocks["attn"].attn == "kv_gather"
        assert plan(cfg, _view(2)).blocks["attn"].attn == "heads"
    whisper = get_config("whisper-large-v3")
    assert {k: b.attn for k, b in plan(whisper, _view(8)).blocks.items()} \
        == {"dec": "whole", "enc": "whole"}
    assert plan(whisper, _view(8)).blocks["dec"].cross == "whole"
    assert plan(whisper, _view(4)).blocks["dec"].cross == "heads"
    for m in (2, 4, 8):
        assert not plan(get_config("internvl2-2b"), _view(m)).vocab
    assert plan(whisper, _view(2)).vocab and not plan(whisper,
                                                      _view(4)).vocab
    zamba = plan(get_config("zamba2-2.7b"), _view(2))
    assert zamba.blocks["mamba"].ssm == "heads"
    assert zamba.blocks["shared"].attn == "heads"
    # 80 SSD heads at model 8 split on their boundaries too
    assert plan(get_config("zamba2-2.7b"), _view(8)).blocks[
        "mamba"].ssm == "heads"
    assert tp.tp_plan(get_config("glm4-9b"), MeshView(("data",), {
        "data": 4})).blocks["attn"].attn == "plain"


def test_kv_heads_of_a_rank_cover_its_q_heads():
    from repro_torch.models.layers import _kv_heads_of
    # glm4-9b at model 4: 8 q heads a rank, one kv head each
    assert [_kv_heads_of(r, 8, 32, 2) for r in range(4)] == [
        (0, 1, None), (0, 1, None), (1, 1, None), (1, 1, None)]
    # 12 q heads over 3 kv heads at model 2: the groups do not align
    assert _kv_heads_of(0, 6, 12, 3) == (0, 2, [0, 0, 0, 0, 1, 1])
    assert _kv_heads_of(1, 6, 12, 3) == (1, 2, [0, 0, 1, 1, 1, 1])


# ------------------------------------------------------------ the JAX side
def _jax_cfg(arch):
    cfg = j_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=TPW.MOE_CAPACITY)
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    """The reference's weights of its four archs and its single-device
    logits; the reduced olmoe's MoE layer, an input and its
    ``_apply_moe_local`` outputs over S = 16 and S = 1."""
    flats, logits = {}, {}
    for arch in JAX_ARCHS:
        cfg = _jax_cfg(arch)
        params = JT.init_params(jax.random.key(0), cfg)
        flats[arch] = flat_tree(params)
        batch = {k: jnp.asarray(v) for k, v in
                 j_batch_for(cfg, TPW.SEQ, TPW.BATCH, step=1).items()}
        logits[arch] = np.asarray(JT.forward_logits(params, cfg, batch,
                                                    dtype=jnp.float32))
    cfg = _jax_cfg("olmoe-1b-7b")
    p = JM.init_moe(jax.random.key(1), cfg.d_model, cfg.moe_d_ff,
                    cfg.n_experts, cfg.n_shared_experts, cfg.act)
    x = np.random.default_rng(0).standard_normal(
        (TPW.BATCH, TPW.SEQ, cfg.d_model)).astype(np.float32)
    moe = {}
    for name, xs in (("train", x), ("decode", x[:, :1])):
        out, aux = JM._apply_moe_local(
            p, jnp.asarray(xs), n_experts=cfg.n_experts, top_k=cfg.top_k,
            act=cfg.act, dtype=jnp.float32,
            capacity_factor=cfg.moe_capacity_factor)
        moe[name] = (np.asarray(out), float(aux))
    return {"flats": flats, "logits": logits, "moe_flat": flat_tree(p),
            "moe_x": x, "moe": moe}


# ------------------------------------------------------------ model 2
@pytest.fixture(scope="module")
def world_of_2(tmp_path_factory, jax_side):
    tmp = tmp_path_factory.mktemp("tp2")
    return spawn_world(TPW.model_2_world, 2, tmp, jax_side["flats"],
                       jax_side["moe_flat"], jax_side["moe_x"], FWD_2,
                       GRAD_2, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("arch", sorted(FWD_2))
def test_forward_at_model_2_matches_the_single_device_forward(world_of_2,
                                                              arch):
    for rank in world_of_2:
        res = rank["forward"][arch]
        assert res["model_ranks"] == 2
        assert res["err"] < FWD_TOL, res["err"]


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_forward_at_model_2_matches_the_jax_forward(world_of_2, jax_side,
                                                    arch):
    got = world_of_2[0]["forward"][arch]["logits"]
    want = jax_side["logits"][arch]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < FWD_TOL, err


def _check_grads(res, label):
    l0, l1 = res["loss"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (label, l0, l1)
    worst = max(res["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, (label, worst)


@pytest.mark.parametrize("name", sorted(GRAD_2))
def test_gradients_at_model_2_match_the_single_device(world_of_2, name):
    for rank in world_of_2:
        _check_grads(rank["grads"][name], name)


def _check_moe(got, want):
    out, aux = want
    assert got["out"].shape == out.shape
    np.testing.assert_allclose(got["out"], out, atol=MOE_TOL, rtol=0)
    assert abs(got["aux"] - aux) <= MOE_TOL


def test_apply_moe_sharded_train_layout_matches_jax(world_of_2, jax_side):
    for rank in world_of_2:
        _check_moe(rank["moe"], jax_side["moe"]["train"])


# ------------------------------------------------------------ data 2 x model 2
@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory, jax_side):
    tmp = tmp_path_factory.mktemp("tp2x2")
    return tmp, spawn_world(TPW.data_2_model_2_world, 4, tmp,
                            str(tmp / "ck"), jax_side["moe_flat"],
                            jax_side["moe_x"], timeout=WORLD_TIMEOUT_S)


TRAINER_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b")


def _close(want, got, label):
    assert sorted(want) == sorted(got), label
    for k in want:
        if isinstance(want[k], dict):
            _close(want[k], got[k], f"{label}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), **STATE_TOL,
                                       err_msg=f"{label}/{k}")


def _same_bits(a, b, label=""):
    assert sorted(a) == sorted(b), label
    for k in a:
        if isinstance(a[k], dict):
            _same_bits(a[k], b[k], f"{label}/{k}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (label, k)
        assert x.tobytes() == y.tobytes(), (label, k)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_at_model_2_follows_the_single_device_trainer(world_2x2,
                                                              arch):
    _, ranks = world_2x2
    r0 = ranks[0][arch]
    assert r0["meshes"] == [(1, 2), (1, 2), (2, 2), (2, 2), (1, 2)]
    assert r0["model_parallel"] == (2, 2) and r0["sharded"]
    assert [s["loss"] for s in r0["stats"]] == pytest.approx(
        [s["loss"] for s in r0["ref_stats"]], rel=1e-5)
    for got, want in zip(r0["stats"], r0["ref_stats"]):
        for key in ("ce_loss", "aux_loss", "grad_norm", "lr"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-8)
    # every rank of a step's mesh reports the same (all-reduced) stats
    for i, mesh in enumerate(r0["meshes"]):
        for r in range(mesh[0] * mesh[1]):
            assert ranks[r][arch]["stats"][i] == r0["stats"][i], (r, i)
    _close(r0["ref_state"], r0["state"], arch)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_at_model_2_checkpoint_reads_back_bit_for_bit(world_2x2,
                                                              arch):
    """Its checkpoint is the gathered state, bit for bit, in the JAX
    package and in a fresh model-2 trainer; resume and failure restore
    keep model 2."""
    tmp, ranks = world_2x2
    r0 = ranks[0][arch]
    assert r0["resumed"] == 5 and r0["lost"] == 1
    assert r0["after"][0]["loss"] == r0["after"][1]["loss"]
    _same_bits(r0["state"], r0["fresh_state"], "resumed")
    _same_bits(r0["state"], r0["restored"], "restored")
    cfg = j_config(arch).reduced()
    tc = JS.TrainConfig(compute_dtype=jnp.float32, remat="none",
                        opt=JO.AdamWConfig(lr=JO.cosine_schedule(1e-3, 2,
                                                                 10)))
    like = jax.tree_util.tree_map(np.asarray, JS.init_train_state(
        jax.random.key(0), cfg, tc))
    back, step = JCK.restore_checkpoint(str(tmp / "ck" / arch), like)
    assert step == 5 and r0["path"].endswith("step_00000005")
    _same_bits(r0["state"], _jax_tree(back), "jax")
    assert os.path.isdir(r0["path"])


def test_apply_moe_sharded_decode_layout_matches_jax(world_2x2, jax_side):
    for rank in world_2x2[1]:
        _check_moe(rank["moe decode"], jax_side["moe"]["decode"])


def test_apply_moe_sharded_train_layout_on_2x2_matches_jax(world_2x2,
                                                           jax_side):
    for rank in world_2x2[1]:
        _check_moe(rank["moe train"], jax_side["moe"]["train"])


# ------------------------------------------------------------ model 4
@pytest.fixture(scope="module")
def world_of_4(tmp_path_factory):
    return spawn_world(TPW.model_4_world, 4,
                       tmp_path_factory.mktemp("tp4"), FWD_4, GRAD_4,
                       timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("name", sorted(FWD_4))
def test_forward_at_model_4_matches_the_single_device_forward(world_of_4,
                                                              name):
    arch, over = FWD_4[name]
    kind, part, mode = MODES_4[name]
    plan = tp.tp_plan(TPW.config(arch, over), _view(4))
    assert getattr(plan.blocks[kind], part) == mode
    for rank in world_of_4:
        res = rank["forward"][name]
        assert res["model_ranks"] == 4
        assert res["err"] < FWD_TOL, res["err"]


@pytest.mark.parametrize("name", sorted(GRAD_4))
def test_gradients_at_model_4_match_the_single_device(world_of_4, name):
    for rank in world_of_4:
        _check_grads(rank["grads"][name], name)


# ------------------------------------------------------------ the lane mesh
def test_lane_mesh_is_the_references_one_axis_mesh():
    ref = j_lane_mesh(jax.devices()[:1])
    mesh = make_lane_mesh(["cpu"])
    assert mesh.axis_names == tuple(ref.axis_names) == ("lanes",)
    assert mesh.shape == dict(ref.shape) == {"lanes": 1}
    two = make_lane_mesh(["cpu", torch.device("cpu")])
    assert two.shape == {"lanes": 2}
    assert two.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least one device"):
        make_lane_mesh([])


def test_shard_lanes_cuts_equal_contiguous_pieces_that_run_as_the_batch():
    structure, batch = _batch("balanced")
    batch = pad_lanes(batch, 4)
    sharding = shard.lane_sharding(["cpu", "cpu"])
    assert [type(p).__name__ for p in sharding.placements] == ["Shard"]
    assert sharding.placements[0].dim == 0
    pieces = shard.shard_lanes(batch, sharding)
    assert len(pieces) == 2
    statics = lane_statics(batch)
    whole = simulate_lanes(batch, _cfg(structure))
    for i, piece in enumerate(pieces):
        want = take_lanes(batch, 2 * i, 2 * i + 2)
        for name in batch._fields:
            got = getattr(piece, name)
            assert got.device == torch.device("cpu")
            assert torch.equal(got, getattr(want, name)), name
        res = simulate_lanes(piece, _cfg(structure), statics=statics)
        for k in ("state", "alloc", "start_t", "end_t", "expand_ops",
                  "shrink_ops"):
            np.testing.assert_array_equal(res[k], whole[k][2 * i:2 * i + 2],
                                          err_msg=k)
    with pytest.raises(ValueError, match="do not split"):
        shard.shard_lanes(take_lanes(batch, 0, 3), sharding)
