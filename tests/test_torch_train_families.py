"""``forward_train`` and its gradients against the JAX package for the
families past the dense stack -- MoE (olmoe, its aux loss), MLA with a dense
first layer and shared experts (DeepSeek-V2), the encoder-decoder
(whisper's frames) and the Mamba-2 stacks (mamba2, zamba2's hybrid, which
train on the CPU only for now) -- at the tolerances of
``test_torch_train_grads.py``; and the remat modes, which must give the
same loss and gradients bit for bit (they change memory, never values).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_grads import check_forward_train  # noqa: E402

from repro.train.data import batch_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_tensors  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b", "whisper-large-v3",
         "mamba2-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_gradients_match_jax(arch):
    check_forward_train(arch, remat="full" if arch == "zamba2-2.7b"
                        else "dots")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    cfg = get_config(arch).reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    batch = to_tensors(batch_for(cfg, 24, 2, step=3, seed=1), "cpu")
    out = {}
    for remat in T.REMAT_MODES:
        model.zero_grad(set_to_none=True)
        loss, metrics = T.forward_train(model, cfg, batch,
                                        dtype=torch.float32, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), metrics["aux_loss"].detach(),
                      {n: p.grad.clone()
                       for n, p in model.named_parameters()})
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1], out["none"][1]), remat
        for n, g in out["none"][2].items():
            assert torch.equal(out[remat][2][n], g), (remat, n)
    with pytest.raises(ValueError, match="remat"):
        T.forward_train(model, cfg, batch, remat="some")
