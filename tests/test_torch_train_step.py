"""The port's train step, optimizer, data pipeline, gradient compression
and ``python -m repro_torch.launch.train`` against the JAX package, on the
CPU.

* ``make_train_step``: three steps from the same JAX-initialised train
  state (carried across with ``train_state_from_numpy``) on the same
  ``batch_for`` batches, f32 compute, a short cosine schedule, for
  ``accum_steps`` 1 and 2, ``compress_grads`` on and off and
  ``master_in_opt``: loss, grad norm and lr each step within 1e-5
  (relative), and after the third step the params, mu, nu, master and the
  error-feedback residuals within 2e-5 + 1e-4 x |value| (f32 sums in
  another order, through three AdamW updates), the step bit-equal.  With
  ``compress_grads`` a gradient element within the sums' noise of a
  rounding boundary may round to the next int8 step on one side only: at
  most 1 element in 10,000 of a part may then miss that tolerance, by at
  most 1e-2 (one step, a leaf's largest |gradient| / 127, in the residual;
  its effect through three updates of at most lr = 1e-3 in the params);
* the schedules at several steps within 1e-6 (f32 cos on two libraries);
* ``batch_for`` (text, vision patches, whisper's frames) byte-equal
  (``tests/test_torch_inputs.py`` holds ``train/data.py`` to the
  reference file);
* ``compress_decompress`` and ``init_residuals`` bit-equal;
* the launch CLI: a 3-step reduced run returns 0 and prints the
  reference's lines; an elastic flag exits 1 naming ROADMAP §A10g.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train_grads import flat_tree  # noqa: E402

import repro.train.data as JDATA  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.elastic import compression as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
import repro_torch.train.data as TDATA  # noqa: E402
from repro_torch.convert import (to_tensors,  # noqa: E402
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.elastic import compression as TC  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

STATS_RTOL = 1e-5
STATE_TOL = dict(atol=2e-5, rtol=1e-4)
# compress_grads: int8 rounding flips (see the module's docstring)
FLIP_FRACTION = 1e-4
FLIP_ATOL = 1e-2


def _jax_tree(state):
    tree = {"params": flat_tree(state["params"]),
            "opt": {k: flat_tree(v) for k, v in state["opt"].items()
                    if k != "step"}}
    tree["opt"]["step"] = np.asarray(state["opt"]["step"])
    if "ef" in state:
        tree["ef"] = flat_tree(state["ef"])
    return tree


@pytest.mark.parametrize("accum,compress,master", [
    (1, False, False), (2, False, True), (1, True, False), (2, True, True)])
def test_three_train_steps_match_jax(accum, compress, master):
    cfg = get_config("glm4-9b").reduced()
    tcs = [mod.TrainConfig(
        compute_dtype=dt, remat="none", accum_steps=accum,
        compress_grads=compress,
        opt=opt.AdamWConfig(lr=opt.cosine_schedule(1e-3, 2, 10),
                            master_in_opt=master))
        for mod, opt, dt in ((JS, JO, jnp.float32),
                             (TS, TO, torch.float32))]
    state_j = JS.init_train_state(jax.random.key(0), cfg, tcs[0])
    state_t = train_state_from_numpy(_jax_tree(state_j), cfg, "cpu")
    assert sorted(state_t["opt"]) == sorted(state_j["opt"])
    step_j = jax.jit(JS.make_train_step(cfg, tcs[0]))
    step_t = TS.make_train_step(cfg, tcs[1])
    for i in range(1, 4):
        batch = JDATA.batch_for(cfg, 16, 4, step=i, seed=0)
        state_j, sj = step_j(state_j, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state_t, st = step_t(state_t, to_tensors(batch, "cpu"))
        for key in ("loss", "grad_norm", "lr", "ce_loss", "aux_loss"):
            np.testing.assert_allclose(float(st[key]), float(sj[key]),
                                       rtol=STATS_RTOL, atol=1e-8,
                                       err_msg=f"step {i} {key}")
    exp, got = _jax_tree(state_j), train_state_to_numpy(state_t)
    assert int(got["opt"].pop("step")) == int(exp["opt"].pop("step")) == 3
    assert sorted(got) == sorted(exp)
    parts = [(p, exp[p], got[p]) for p in exp if p != "opt"] + [
        (k, exp["opt"][k], got["opt"][k]) for k in exp["opt"]]
    for part, e_tree, g_tree in parts:
        assert sorted(e_tree) == sorted(g_tree), part
        missed, total = 0, 0
        for key in e_tree:
            e, g = e_tree[key], g_tree[key]
            assert g.shape == e.shape and g.dtype == e.dtype, key
            diff = np.abs(g - e)
            miss = diff > STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(e)
            missed, total = missed + int(miss.sum()), total + e.size
            assert not compress or (diff <= FLIP_ATOL).all(), (part, key)
        assert missed <= (FLIP_FRACTION * total if compress else 0), (
            f"{part}: {missed} of {total} elements off")


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_jax(kind):
    j = getattr(JO, f"{kind}_schedule")(3e-4, 100, 10_000)
    t = getattr(TO, f"{kind}_schedule")(3e-4, 100, 10_000)
    for step in (0, 1, 50, 99, 100, 101, 2_500, 9_999, 10_000, 20_000):
        np.testing.assert_allclose(float(t(step)), float(j(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))
        assert t(step).dtype == torch.float32


def test_adamw_defaults_match_jax():
    j, t = JO.AdamWConfig(), TO.AdamWConfig()
    for f in ("b1", "b2", "eps", "weight_decay", "grad_clip",
              "master_in_opt"):
        assert getattr(j, f) == getattr(t, f), f
    assert float(t.lr(500)) == pytest.approx(float(j.lr(500)), rel=1e-6)
    jt, tt = JS.TrainConfig(), TS.TrainConfig()
    assert (jt.remat, jt.accum_steps, jt.compress_grads) == (
        tt.remat, tt.accum_steps, tt.compress_grads)
    assert (tt.compute_dtype, tt.param_dtype) == (torch.bfloat16,
                                                  torch.float32)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_batch_for_is_byte_identical(arch):
    cfg = get_config(arch).reduced()
    for step, seed in ((0, 0), (3, 7)):
        j = JDATA.batch_for(cfg, 40, 3, step=step, seed=seed)
        t = TDATA.batch_for(cfg, 40, 3, step=step, seed=seed)
        assert sorted(j) == sorted(t)
        for k in j:
            assert j[k].dtype == t[k].dtype and j[k].tobytes() == \
                t[k].tobytes(), k


def test_compress_decompress_is_bit_equal():
    """Per JAX leaf: a segment's stacked layers (``segments/0/w``, the
    port's ``segments.0.<layer>.w``) share one scale."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((33, 7)).astype(np.float32),
             "b": (rng.standard_normal(100) * 1e-3).astype(np.float32),
             "c": np.zeros(5, np.float32),
             "segments/0/w": rng.standard_normal((3, 6, 4)).astype(
                 np.float32) * np.float32([[[1.0]], [[1e-2]], [[30.0]]])}
    res = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
           for k, v in grads.items()}
    jd, jr = JC.compress_decompress({k: jnp.asarray(v)
                                     for k, v in grads.items()},
                                    {k: jnp.asarray(v)
                                     for k, v in res.items()})

    def port_names(tree):
        out = {}
        for k, v in tree.items():
            if k.startswith("segments/"):
                out.update({f"segments.0.{i}.w": torch.from_numpy(row)
                            for i, row in enumerate(v)})
            else:
                out[k] = torch.from_numpy(v)
        return out

    td, tr = TC.compress_decompress(port_names(grads), port_names(res))
    for k in grads:
        if k.startswith("segments/"):
            got_d = np.stack([td[f"segments.0.{i}.w"].numpy()
                              for i in range(3)])
            got_r = np.stack([tr[f"segments.0.{i}.w"].numpy()
                              for i in range(3)])
        else:
            got_d, got_r = td[k].numpy(), tr[k].numpy()
        assert np.asarray(jd[k]).tobytes() == got_d.tobytes(), k
        assert np.asarray(jr[k]).tobytes() == got_r.tobytes(), k
    zeros = TC.init_residuals({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()


def test_launch_train_runs_a_reduced_model(capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "3",
                 "--batch", "2", "--seq", "16", "--log-every", "1",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "[train] step 1", "[train] step 2", "[train] step 3",
        "[train] done"]
    assert "loss=" in out[0] and "lr=" in out[0] and " -> " in out[-1]


@pytest.mark.parametrize("flag", [["--malleable"], ["--resize-every", "4"],
                                  ["--ckpt-dir", "ck", "--resume"]])
def test_launch_train_elastic_flags_exit_1_naming_a10g(flag, capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
                 *flag]) == 1
    assert "ROADMAP §A10g" in capsys.readouterr().err
