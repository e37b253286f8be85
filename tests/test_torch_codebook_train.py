# ------------------------------------------------------------------
"""Training through the generic VQModel path against the JAX package:
VQ-EMA steps with the codebook state moving (synthetic and real-world
steps), and the optimizer on parameters the loss does not reach
(Random_VQ's encoder, LFQ's frozen project_out), plus the card-only
VQ-EMA step with the kernels. Config, weights and helpers are
test_torch_codebook_model.py's; the JAX Mamba runs its Pallas kernels in
interpret mode. Tolerances, float32: losses rtol 1e-4, parameters atol
1e-5 at lr 1e-3 (as in test_torch_train.py); codebook state rtol 1e-4
with atol 1e-6 x the buffer's max |value|: embed_avg sums ~6,000 encoder
outputs per code whose signs cancel, so an entry near 0 carries the
rounding of terms of the buffer's scale. The card test holds the state
after one step to rtol 1e-4 / atol 1e-5.

The JAX side is imported inside fixtures, so the card-only test also
collects where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_codebook_train.py -m gpu``).
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import Config
from idee_tpu_torch.data.fake import write_fake_reanalysis
from idee_tpu_torch.data.loader import collate
from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.models.interop import flax_to_state_dict
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.train.driver_real import make_reanalysis_dataset
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step
from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                             make_train_step_real)
from test_torch_codebook_model import (  # noqa: F401 (jx, pallas: fixtures)
    CODEBOOKS, EMA, T_LINE, VARS, _batches, _buffers, _close,
    _jax_variables, _port_model, _tiny_config, jx, pallas)

torch.set_num_threads(1)


# ---------------------------------------------------------------- train steps

def _jax_steps(jx, cfg, model_j, variables, batches, real=False):
    """JAX: per step the loss sum, the params and the codebook collection
    after it (make_train_step / make_train_step_real)."""
    jcfg = jx.cfg(cfg)
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    state = jx.state.TrainState.create(
        apply_fn=model_j.apply, params=params,
        tx=jx.state.make_optimizer(jcfg, 3, params=params),
        rng=jx.jax.random.PRNGKey(0), extra_vars=extra)
    if real:
        step = jx.steps_real.make_train_step_real(model_j, jcfg,
                                                  donate=False)
        fresh = jx.steps_real.init_epoch_metrics_real
    else:
        step = jx.steps.make_train_step(model_j, jcfg, t0=1.0, donate=False,
                                        steps_per_epoch=3)
        fresh = lambda: jx.steps.init_epoch_metrics(  # noqa: E731
            (3, T_LINE, 16, 16))
    target = build_model(cfg).state_dict()
    out = []
    for b in batches:
        state, metrics = step(state, fresh(),
                              {k: jx.jnp.asarray(v) for k, v in b.items()})
        out.append((float(metrics["loss_sums"]["loss"]),
                    flax_to_state_dict(state.params, target),
                    flax_to_state_dict({"params": {}, **(
                        state.extra_vars or {})}, target)))
    return out


def _port_steps(cfg, model, batches, real=False):
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    if real:
        step, fresh = make_train_step_real(model, cfg), \
            lambda: init_epoch_metrics_real("cpu")
    else:
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        fresh = lambda: init_epoch_metrics((3, T_LINE, 16, 16),  # noqa
                                           "cpu")
    out = []
    for b in batches:
        _, metrics = step(state, fresh(),
                          {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((metrics["loss_sums"]["loss"].item(),
                    {k: p.detach().clone()
                     for k, p in model.named_parameters()},
                    {k: v.clone() for k, v in _buffers(model).items()}))
    return out


def _same_trajectory(got, want):
    for i, ((gl, gp, gb), (wl, wp, wb)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-4, err_msg=f"loss {i}")
        assert sorted(gp) == sorted(wp) and sorted(gb) == sorted(wb)
        for k, w in wp.items():
            _close(gp[k], w, f"step {i} param {k}", rtol=0.0, atol=1e-5)
        for k, w in wb.items():
            _close(gb[k], w, f"step {i} buffer {k}",
                   atol=1e-6 * float(np.abs(np.asarray(w)).max()))


# VQ-EMA: the codebook state moves with every step; Random_VQ: the encoder
# gets no gradient (its output is stop-gradient) but, as in JAX, Adam's
# coupled weight decay still moves it; LFQ with a frozen output
# projection (the packed path): the same for project_out
@pytest.mark.parametrize("name,kw,n_steps", [
    ("VQ_EMA", EMA, 3), ("Random_VQ", CODEBOOKS["Random_VQ"], 2),
    ("LFQ_frozen_out", dict(codebook_freeze_out=True), 2)])
def test_train_steps_match_jax(jx, pallas, name, kw, n_steps):
    cfg = _tiny_config(**kw)
    model_j, variables = _jax_variables(jx, cfg)
    batches = _batches(n_steps, seed=3)
    want = _jax_steps(jx, cfg, model_j, variables, batches)
    model = _port_model(cfg, variables)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    got = _port_steps(cfg, model, batches)
    _same_trajectory(got, want)
    if name == "VQ_EMA":  # the state moved with every step
        assert not np.allclose(want[0][2]["vq.embed"], want[-1][2]["vq.embed"])
    else:
        moved = ("encoder." if name == "Random_VQ" else "vq.project_out.")
        for k, p in model.named_parameters():
            if k.startswith(moved):
                assert not torch.equal(p.detach(), before[k]), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("real")
    write_fake_reanalysis(str(root / "CERRA"), str(root / "NOAA_CERRA"),
                          variables=VARS, years=("1984",), seed=0)
    return root


def test_real_train_step_with_vq_ema_matches_jax(jx, pallas, tree,
                                                 tmp_path):
    cfg = Config(encoder="Mamba", in_channels=2, in_channels_dynamic=3,
                 variables=VARS, variables_static=[], delta_t=8,
                 root_CERRA=str(tree / "CERRA"),
                 root_NOAA_CERRA=str(tree / "NOAA_CERRA"),
                 years_train=["1984"], grid_override=(16, 16), x_max=16,
                 y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                 codebook_dim=8, cls_dim=8, batch_size=2,
                 is_clima_scale=False, dir_log=str(tmp_path), name="real",
                 **EMA)
    ds = make_reanalysis_dataset(cfg, "CERRA", ["1984"], is_aug=False)
    batch = collate([ds[i] for i in range(2)])
    model_j, variables = _jax_variables(jx, cfg, in_channels=2)
    want = _jax_steps(jx, cfg, model_j, variables, [batch], real=True)
    got = _port_steps(cfg, _port_model(cfg, variables), [batch], real=True)
    _same_trajectory(got, want)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_vq_ema_train_step_on_card_matches_cpu(cuda):
    """One VQ-EMA train step on the card (the fused scan forward and
    backward kernels) against the same step on the CPU (the plain scan):
    loss, gradients and the codebook state after the step."""
    cfg = _tiny_config(**EMA)
    b = _batches(1, seed=6)[0]
    runs = []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        before = dict(ss.launches)
        _, metrics = step(state, init_epoch_metrics((3, T_LINE, 16, 16),
                                                    dev),
                          {k: torch.from_numpy(v).to(dev)
                           for k, v in b.items()})
        runs.append((metrics["loss_sums"]["loss"].item(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()},
                     {k: v.cpu() for k, v in _buffers(model).items()}))
    assert ss.launches[ss.FUSED_FWD] == before[ss.FUSED_FWD] + 3
    assert ss.launches[ss.FUSED_BWD] == before[ss.FUSED_BWD] + 3
    (l_cpu, g_cpu, b_cpu), (l_gpu, g_gpu, b_gpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    for k, want in g_cpu.items():
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (g_gpu[k] - want).abs().max().item() <= tol, k
        if k.startswith("encoder."):
            assert g_gpu[k].abs().max().item() > 0, k
    for k, want in b_cpu.items():
        torch.testing.assert_close(b_gpu[k], want, rtol=1e-4, atol=1e-5)
