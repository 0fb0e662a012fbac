"""The port's malleable training job (``repro_torch.elastic``) against the
JAX package's, on the CPU.

* checkpoints: the reference's ``test_checkpoint_roundtrip`` on the port's
  functions; ``keep`` GC and ``latest_step`` as the reference's; a JAX
  checkpoint of a mini config's train state (with residuals and master
  weights) restores in the port bit for bit and a port checkpoint in JAX,
  the two packages writing the same manifest; bfloat16 leaves refused by
  name;
* ``ElasticTrainer`` at width 1 from the JAX trainer's initial state
  (through ``convert``) through the reference test's schedule
  (``tests/test_elastic.py``: 6 steps, ``ckpt_every=3``,
  ``fail_and_restore(1)``, a fresh trainer's ``try_resume``, a step each,
  ``resize(1)``), f32 compute: losses within ``STATS_RTOL`` of JAX's, the
  final state within ``STATE_TOL``, step counts, lost steps and plan bytes
  exact, the plan's seconds the reference's times 50 / 450 (the two link
  rates);
* a gloo world of 2 CPU processes: a trainer at width 1 resizes to 2, steps,
  resizes back and steps (stablelm, olmoe at its default capacity factor,
  where the reduced config drops a third of its assignments, and olmoe with
  2 accumulated microbatches): losses within 1e-5 and the final state
  within ``STATE_TOL`` of a width-1 trainer's; then ``launch.train
  --malleable`` across widths 1 and 2, a failure losing a step;
* a gloo world of 4 processes: ``reshard_tree`` on a ``(2, 2)`` mesh leaves
  each rank its spec's slice (fsdp specs on a tree; the model rules on an
  LM's parameters), ``full_tensor()`` equal to rank 0's input, and a
  reshard onto ``(1, 1)`` gathers it back;
* ``python -m repro_torch.launch.train --malleable`` in one process: the
  reference's lines in its order, a resume, and nothing left to run.

The spawned worlds take ~10 s each; each has its own time limit.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dp_worker as W  # noqa: E402
from test_torch_train_step import STATE_TOL, STATS_RTOL, _jax_tree  # noqa
from repro.configs import get_config  # noqa: E402
from repro.elastic import checkpoint as JCK  # noqa: E402
from repro.elastic import resharding as JRS  # noqa: E402
from repro.elastic.manager import ElasticTrainer as JTrainer  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.convert import (train_state_into,  # noqa: E402
                                 train_state_to_numpy)
from repro_torch.elastic import checkpoint as TCK  # noqa: E402
from repro_torch.elastic import manager as TM  # noqa: E402
from repro_torch.elastic import resharding as TRS  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

WORLD_TIMEOUT_S = 150
# the plan's seconds: bytes over the link rate, the reference's TPU ICI
# link (50 GB/s) against one H100's NVLink (450 GB/s a direction)
EST_RATIO = 50.0 / 450.0


@pytest.fixture(autouse=True)
def closes_its_world():
    yield
    TM.close_world()


def _mini(get):
    return dataclasses.replace(get("stablelm-1.6b").reduced(), n_layers=2,
                               d_model=64, d_ff=128, vocab=256, name="mini")


def _tc(mod, optim, dtype, opt=None, **kw):
    return mod.TrainConfig(compute_dtype=dtype, remat="none",
                           opt=optim.AdamWConfig(lr=optim.cosine_schedule(
                               1e-3, 2, 10), **(opt or {})), **kw)


def _same_bits(a, b, label=""):
    assert sorted(a) == sorted(b), label
    for k in a:
        if isinstance(a[k], dict):
            _same_bits(a[k], b[k], f"{label}/{k}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (label, k)
        assert x.tobytes() == y.tobytes(), (label, k)


def _close(exp, got, label=""):
    assert sorted(exp) == sorted(got), label
    for k in exp:
        if isinstance(exp[k], dict):
            _close(exp[k], got[k], f"{label}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(exp[k]), **STATE_TOL,
                                       err_msg=f"{label}/{k}")


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip(tmp_path):
    """The reference's test on the port's functions."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.ones((2, 2), np.int32)}}
    TCK.save_checkpoint(str(tmp_path), 7, tree)
    TCK.save_checkpoint(str(tmp_path), 9, tree)
    assert TCK.latest_step(str(tmp_path)) == 9
    restored, step = TCK.restore_checkpoint(str(tmp_path), tree)
    assert step == 9
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_checkpoint_gc_and_latest_step_as_the_reference(tmp_path, keep):
    tree = {"x": np.zeros(3, np.float32)}
    for mod, d in ((JCK, tmp_path / "j"), (TCK, tmp_path / "t")):
        assert mod.latest_step(str(d)) is None
        for step in (3, 1, 12, 5):
            mod.save_checkpoint(str(d), step, tree, keep=keep)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    assert TCK.latest_step(str(tmp_path / "t")) == 12
    assert not [n for n in os.listdir(tmp_path / "t")
                if n.startswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        TCK.restore_checkpoint(str(tmp_path / "none"), tree)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path):
    """A JAX checkpoint of a train state (residuals and master weights
    too) restores in the port bit for bit, and a port checkpoint in JAX;
    both write the same manifest for the same state."""
    kw = dict(compress_grads=True, opt={"master_in_opt": True})
    tcj = _tc(JS, JO, jnp.float32, **kw)
    tct = _tc(TS, TO, torch.float32, **kw)
    host_j = jax.tree_util.tree_map(np.asarray, JS.init_train_state(
        jax.random.key(0), _mini(get_config), tcj))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save_checkpoint(dj, 3, host_j)

    state = TS.init_train_state(_mini(t_config), tct,
                                torch.Generator().manual_seed(1), "cpu")
    restored, step = TCK.restore_checkpoint(dj, TM.state_like(state))
    assert step == 3
    train_state_into(state, restored)
    _same_bits(_jax_tree(host_j), train_state_to_numpy(state))

    TCK.save_checkpoint(dt, 3, train_state_to_numpy(state))
    assert _manifest(dt, 3) == _manifest(dj, 3)

    other = TS.init_train_state(_mini(t_config), tct,
                                torch.Generator().manual_seed(2), "cpu")
    TCK.save_checkpoint(dt, 4, train_state_to_numpy(other))
    back, step = JCK.restore_checkpoint(dt, host_j)
    assert step == 4
    _same_bits(train_state_to_numpy(other), _jax_tree(back))


def test_checkpoint_refuses_bfloat16_by_name(tmp_path):
    with pytest.raises(ValueError, match="p/q"):
        TCK.save_checkpoint(str(tmp_path), 1, {"p": {
            "q": np.zeros(2, dtype=jnp.bfloat16)}})
    assert not os.listdir(tmp_path)
    tr = TM.ElasticTrainer(_mini(t_config), TS.TrainConfig(
        remat="none", param_dtype=torch.bfloat16), global_batch=2,
        seq_len=8, width=1, ckpt_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match=r"leaf params/\S+ is bfloat16"):
        tr.checkpoint()


# ------------------------------------------------------- trainer, width 1
def test_trainer_follows_the_jax_trainer_at_width_1(tmp_path):
    """The reference test's schedule on both trainers from one state."""
    tcj = _tc(JS, JO, jnp.float32)
    tct = _tc(TS, TO, torch.float32)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(global_batch=4, seq_len=16, width=1, seed=0)
    jt = JTrainer(_mini(get_config), tcj, ckpt_dir=dj, ckpt_every=3, **kw)
    pt = TM.ElasticTrainer(_mini(t_config), tct, ckpt_dir=dt, ckpt_every=3,
                           device="cpu", **kw)
    train_state_into(pt.state, _jax_tree(jt.state))

    def same_step(j, p, label):
        sj, sp = j.step(), p.step()
        assert sorted(sp) == sorted(sj)
        for key in sj:
            np.testing.assert_allclose(sp[key], sj[key], rtol=STATS_RTOL,
                                       atol=1e-8, err_msg=f"{label} {key}")
        assert p.step_num == j.step_num
        return sp["loss"]

    for i in range(6):
        same_step(jt, pt, f"step {i + 1}")
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    assert _manifest(dt, 6) == _manifest(dj, 6)
    assert pt.fail_and_restore(1) == jt.fail_and_restore(1) == 0
    assert pt.step_num == jt.step_num == 6

    jt2 = JTrainer(_mini(get_config), tcj, ckpt_dir=dj, **kw)
    pt2 = TM.ElasticTrainer(_mini(t_config), tct, ckpt_dir=dt,
                            device="cpu", **kw)
    assert pt2.try_resume() == jt2.try_resume() == 6
    _same_bits(train_state_to_numpy(pt.state), train_state_to_numpy(
        pt2.state))
    loss = same_step(jt, pt, "after the restore")
    assert same_step(jt2, pt2, "resumed") == loss

    plan_j, plan_p = jt.resize(1), pt.resize(1)
    assert (plan_p.old_dp, plan_p.new_dp) == (plan_j.old_dp, plan_j.new_dp)
    assert plan_p.param_bytes == plan_j.param_bytes == plan_j.bytes_moved
    assert plan_p.bytes_moved == plan_j.bytes_moved
    assert (JRS.ResizePlan.LINK_GBPS / TRS.ResizePlan.LINK_GBPS
            == pytest.approx(EST_RATIO, rel=1e-12))
    assert plan_p.est_seconds == pytest.approx(
        plan_j.est_seconds * EST_RATIO, rel=1e-12)
    assert dataclasses.asdict(pt.stats)["restores"] == jt.stats.restores
    assert (pt.stats.steps, pt.stats.resizes) == (jt.stats.steps,
                                                   jt.stats.resizes)
    _close(_jax_tree(jt.state), train_state_to_numpy(pt.state))
    _close(_jax_tree(jt2.state), train_state_to_numpy(pt2.state))


def test_trainer_refuses_tensor_parallelism_and_a_too_wide_mesh():
    """Tensor parallelism is taken (the runs are in
    ``tests/test_torch_tensor_parallel.py``); a (1, 2) mesh, like a (2, 1)
    one, needs two ranks, which a world of one has not."""
    with pytest.raises(ValueError, match="job needs 2 devices, have 1"):
        TM.ElasticTrainer(_mini(t_config), TS.TrainConfig(remat="none"),
                          global_batch=2, seq_len=8, width=1,
                          model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="job needs 2 devices, have 1"):
        TM.ElasticTrainer(_mini(t_config), TS.TrainConfig(remat="none"),
                          global_batch=2, seq_len=8, width=2, device="cpu")


def test_cpu_trainer_on_a_card_host_builds_a_cpu_mesh(monkeypatch):
    """The mesh takes its device type from the world's backend, not from
    the machine: a CPU job where a card is present runs on gloo and a
    ``cpu`` mesh, and its integers cross on the CPU."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tr = TM.ElasticTrainer(_mini(t_config), TS.TrainConfig(remat="none"),
                           global_batch=2, seq_len=8, width=1,
                           device="cpu")
    assert dist.get_backend() == "gloo"
    assert tr.mesh.device_type == "cpu"
    assert TRS.make_job_mesh(1).device_type == "cpu"


def test_job_meshes_are_reused_under_one_world():
    """A resize back to a width reuses that width's mesh (no new process
    groups); a world opened anew builds its own."""
    tr = TM.ElasticTrainer(_mini(t_config), TS.TrainConfig(remat="none"),
                           global_batch=2, seq_len=8, width=1,
                           device="cpu")
    first = tr.mesh
    step = tr._step_fn()
    tr.resize(1)
    assert TRS.make_job_mesh(1) is first and tr.mesh is first
    assert tr._step_fn() is step
    TM.close_world()
    TM.ensure_world("cpu")
    assert TRS.make_job_mesh(1) is not first


@pytest.mark.parametrize("accum,width,rank,rows", [
    (1, 1, 0, [0, 1, 2, 3]), (1, 2, 1, [2, 3]), (2, 2, 0, [0, 2]),
    (2, 2, 1, [1, 3]), (2, 1, 0, [0, 1, 2, 3])])
def test_local_rows_are_each_ranks_block_of_each_microbatch(accum, width,
                                                            rank, rows):
    assert TM.local_rows(4, width, accum, rank).tolist() == rows
    with pytest.raises(ValueError):
        TM.local_rows(6, 4, 1, 0)


# ------------------------------------------------- the spawned gloo worlds
def spawn_world(fn, world, tmp_path, *args, timeout=WORLD_TIMEOUT_S):
    """``fn(rank, *args)`` on each rank of a gloo world of ``world`` CPU
    processes; returns each rank's value (an error fails the test)."""
    import torch.multiprocessing as mp
    init, out = str(tmp_path / "init"), str(tmp_path / "out")
    ctx = mp.start_processes(W.run, args=(fn, world, init, out, *args),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__}: the world of {world} "
                                   f"did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = [torch.load(f"{out}.{r}", weights_only=False)
               for r in range(world)]
    for r, res in enumerate(results):
        assert "ok" in res, f"rank {r}:\n{res.get('error')}"
    return [res["ok"] for res in results]


SCHEDULES = {"stablelm": ("stablelm-1.6b", 1), "olmoe": ("olmoe-1b-7b", 1),
             "olmoe accum 2": ("olmoe-1b-7b", 2)}


@pytest.fixture(scope="module")
def world_of_2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    return spawn_world(W.elastic_world, 2, tmp, str(tmp / "ck"))


@pytest.fixture(scope="module")
def width_1():
    """Each schedule's steps on a width-1 trainer, and the assignments the
    MoE layers dropped."""
    out = {}
    for name, (arch, accum) in SCHEDULES.items():
        drops = []
        plan = M.dispatch_plan

        def counting(*a, **k):
            e, pos, keep = plan(*a, **k)
            drops.append(int((~keep).sum()))
            return e, pos, keep

        M.dispatch_plan = counting
        try:
            tr = TM.ElasticTrainer(W.elastic_config(arch),
                                   W.train_config(accum), global_batch=4,
                                   seq_len=16, width=1, seed=0, device="cpu")
            n = sum(a for kind, a in W.RESIZE_SCHEDULE if kind == "step")
            stats = [tr.step() for _ in range(n)]
        finally:
            M.dispatch_plan = plan
            TM.close_world()
        out[name] = (stats, tr.state, sum(drops))
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_resize_1_2_1_on_a_gloo_world_equals_width_1(name, world_of_2,
                                                     width_1):
    stats, state, drops = width_1[name]
    rank0, rank1 = (w[name] for w in world_of_2)
    if name.startswith("olmoe"):
        assert drops > 0, "the default capacity factor drops assignments"
    assert [s["loss"] for s in rank0["stats"]] == pytest.approx(
        [s["loss"] for s in stats], rel=1e-5)
    for got, want in zip(rank0["stats"], stats):
        for key in ("ce_loss", "aux_loss", "grad_norm", "lr"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-8)
    # rank 1 is in the mesh for steps 3-4 only, and then holds the same
    # (all-reduced) stats as rank 0
    assert [bool(s) for s in rank1["stats"]] == [False, False, True, True,
                                                 False]
    assert rank1["stats"][2:4] == rank0["stats"][2:4]
    bytes_ = TRS.tree_bytes(state)
    assert rank0["plans"] == [(1, 2, bytes_), (2, 1, bytes_)]
    assert rank0["resizes"] == (2, 1, 1) and rank0["step_num"] == 5
    for part, want in (("params", dict(state["params"].named_parameters())),
                       ("mu", state["opt"]["mu"])):
        for n, t in want.items():
            np.testing.assert_allclose(rank0["final"][part][n].numpy(),
                                       t.detach().numpy(), **STATE_TOL,
                                       err_msg=f"{part} {n}")


def test_launch_train_malleable_across_widths_1_and_2(world_of_2):
    (rc0, out0), (rc1, out1) = (w["cli"] for w in world_of_2)
    assert rc0 == rc1 == 0 and out1 == ""
    lines = out0.splitlines()
    assert [line.split(" (")[0] for line in lines[:4]] == [
        "[train] step 2: scheduler resized DP width -> 2",
        "[train] step 4: scheduler resized DP width -> 1",
        "[train] step 5: node failure injected; lost 1 steps, restarted "
        "at 4",
        "[train] step 6: scheduler resized DP width -> 2"]
    assert lines[4].startswith("[train] done: 6 steps, final loss ")
    assert lines[4].endswith("resizes=3 restores=1") and len(lines) == 5


def test_reshard_tree_on_a_2x2_gloo_world(tmp_path):
    out = spawn_world(W.reshard_world, 4, tmp_path)
    src = out[0]["rank0_src"]
    coords = sorted(r["coord"] for r in out)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert out[0]["specs"] == {
        "w/segments.0.0.attn.wq": ("data", "model"),
        "w/segments.0.1.attn.wq": ("data", "model"),
        "w/embed.table": ("model", "data"), "w/final_norm.scale": (None,),
        "step": ()}
    for r in out:
        d, m = r["coord"]
        for k in ("segments.0.0.attn.wq", "segments.0.1.attn.wq"):
            local, place = r["local"][k]
            assert [type(p).__name__ for p in place] == ["Shard", "Shard"]
            assert torch.equal(local, src["w"][k][4 * d:4 * d + 4,
                                                  2 * m:2 * m + 2])
        local, _ = r["local"]["embed.table"]
        assert torch.equal(local, src["w"]["embed.table"][3 * m:3 * m + 3,
                                                          4 * d:4 * d + 4])
        local, place = r["local"]["final_norm.scale"]
        assert place is None and torch.equal(local,
                                             src["w"]["final_norm.scale"])
        assert r["step"] == 7
        for k, v in src["w"].items():
            assert torch.equal(r["full"][k], v), k
        assert r["lm_sharded"] and r["lm_sharded"] == out[0]["lm_sharded"]
        for n, v in src["lm"].items():
            assert torch.equal(r["lm_full"][n], v), n
        assert r["too_wide"] == "job needs 6 devices, have 4"
    for k, v in src["w"].items():
        kind, t = out[0]["back"][k]
        assert kind == "Tensor" and torch.equal(t, v), k
    assert all(not any(r["lm_specs"][f"lm/{n}"]) is (n not in r[
        "lm_sharded"]) for r in out[:1] for n in src["lm"])


# ------------------------------------------------------------ the CLI
MALLEABLE = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
             "--malleable", "--resize-every", "2", "--fail-at", "4",
             "--ckpt-every", "2"]


def test_launch_train_malleable_runs_resumes_and_ends(tmp_path, capsys):
    """The acceptance run, its resume to step 8, and a resume with nothing
    left to run (where the reference's ``main`` reads a loss no step gave,
    the port says so)."""
    from repro_torch.launch.train import main
    ck = ["--ckpt-dir", str(tmp_path)]
    assert main(MALLEABLE + ck + ["--steps", "6"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" (")[0] for line in lines[:4]] == [
        "[train] step 2: scheduler resized DP width -> 1",
        "[train] step 4: scheduler resized DP width -> 1",
        "[train] step 4: node failure injected; lost 0 steps, restarted "
        "at 4",
        "[train] step 6: scheduler resized DP width -> 1"]
    assert "bytes moved, est " in lines[0] and "s on NVLink)" in lines[0]
    assert lines[4].startswith("[train] done: 6 steps, final loss ")
    assert lines[4].endswith("resizes=0 restores=1") and len(lines) == 5
    assert TCK.latest_step(str(tmp_path)) == 6

    assert main(MALLEABLE + ck + ["--steps", "8", "--resume",
                                  "--log-every", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resume: restored step 6"
    assert [line.split(":")[0] for line in lines[1:]] == [
        "[train] step 7", "[train] step 8", "[train] step 8",
        "[train] done"]
    assert "resized DP width -> 1" in lines[2] and "loss=" in lines[3]
    assert lines[4].startswith("[train] done: 8 steps, final loss ")

    assert main(MALLEABLE + ck + ["--steps", "8", "--resume"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "[train] resume: restored step 8",
        "[train] done: 8 steps, no step run (nothing left to run), "
        "resizes=0 restores=0"]
