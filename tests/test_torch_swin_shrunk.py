# ------------------------------------------------------------------
"""Swin_3D on inputs no larger than a window, and the two patch modules
that nothing calls (nn/swin3d.py), against the JAX package.

JAX builds each block's attention at the window that
``get_window_size`` shrinks to the input, so its bias table has the
shrunk shape; the port builds it from the ``input_size`` it is given.
CPU, float32, the flax trees' shapes filled with N(0.02, std) from a
numpy seed and carried across by ``flax_to_state_dict`` (strict: every
shape equal to flax's); the port's window attention runs its plain
version on CPU tensors. Tolerances are tests/test_torch_swin.py's (atol
1e-5, rtol 1e-4) for the modules, and tests/test_torch_baselines_mil.py's
for the train step (loss rtol 1e-5, vote sums equal, step-1 gradients
rtol 1e-4 / atol 1e-6, parameters after the Adam step atol 1e-5 but for
a share of 0.5 % held to 2 lr), whose JAX side runs the window
attention's Pallas kernels in interpret mode:
  * PackedSwinBlock3D at D = 1, at D equal to the window (the shift
    zeroed there), at D = 4 under an (8, 1, 1) window, and at H, W
    smaller than 4; Swin_3D at T = 1, T = 2, T = 4 and a 3 x 3 grid; a
    forward at another geometry raises;
  * one DeepMIL train step over Swin_3D at delta_t 4 (stage 1's window
    (4, 1, 1)); the composite VQModel runs at delta_t 8 only (its
    classifier's three stride-2 convolutions collapse T = 8 to 1);
  * PatchEmbed3D with and without patch_norm, with padding;
  * PackedPatchMerging at D = 1 and D = 2 (and 3) with odd H and W.
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch

from idee_tpu_torch.baselines.mil.driver import (init_mil_metrics,
                                                 make_mil_train_step)
from idee_tpu_torch.models.interop import flax_to_state_dict
from idee_tpu_torch.nn import swin3d
from idee_tpu_torch.train.state import create_train_state
from test_torch_swin import _apply, _close, _flax, _port, _x, jx  # noqa

torch.set_num_threads(1)

V, DIM = 3, 8


@pytest.mark.parametrize("shape,ws,shift,shrunk", [
    ((1, 1, 8, 8), (2, 4, 4), (1, 2, 2), (1, 4, 4)),   # D = 1
    ((1, 2, 8, 8), (2, 4, 4), (1, 2, 2), (2, 4, 4)),   # D = window: no shift
    ((2, 4, 4, 4), (8, 1, 1), (4, 0, 0), (4, 1, 1)),   # stage 1 at delta_t 4
    ((1, 4, 3, 2), (2, 4, 4), (1, 2, 2), (2, 3, 2)),   # H, W under 4
])
def test_packed_swin_block3d_at_a_shrunk_window(jx, shape, ws, shift,
                                                shrunk):
    kw = dict(num_heads=2, window_size=ws, shift_size=shift)
    x = _x(shape + (V * DIM,))
    jmod = jx.sw.PackedSwinBlock3D(n_groups=V, dim=DIM, **kw)
    p = _flax(jx, jmod, x)
    table = p["attn"]["relative_position_bias_table"]
    assert table.shape[1] == np.prod([2 * w - 1 for w in shrunk])
    port = _port(swin3d.PackedSwinBlock3D(V, DIM, **kw,
                                          input_size=shape[1:]), p)
    assert port.attn.window_size == shrunk
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))


def test_a_block_refuses_a_geometry_it_was_not_built_for():
    block = swin3d.PackedSwinBlock3D(V, DIM, 2, window_size=(8, 1, 1),
                                     input_size=(4, 4, 4))
    with pytest.raises(ValueError, match="input_size"):
        block(torch.zeros(1, 8, 4, 4, V * DIM))
    # built at the configured window, a smaller input raises too
    with pytest.raises(ValueError, match=r"\(4, 1, 1\)"):
        swin3d.PackedSwinBlock3D(V, DIM, 2, window_size=(8, 1, 1))(
            torch.zeros(1, 4, 4, 4, V * DIM))


@pytest.mark.parametrize("thw", [(1, 8, 8), (2, 8, 8), (4, 16, 16),
                                 (8, 3, 3)])
def test_swin_encoder_at_a_shrunk_window(jx, thw):
    kw = dict(in_vars=V, in_chans=1, embed_dim=[8, 8], depths=[2, 1])
    x = _x((1, V, 1) + thw)
    jmod = jx.sw.Swin_3D(**kw)
    p = _flax(jx, jmod, x, std=0.05)
    port = _port(swin3d.Swin_3D(**kw, input_size=thw), p)
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))


# ---------------------------------------------------------------- training

@pytest.fixture(scope="module")
def mil_jx():
    from types import SimpleNamespace

    import jax

    from idee_tpu.baselines.config import mil_config as jax_mil_config
    from idee_tpu.baselines.mil import driver as jdriver
    from idee_tpu.baselines.mil.models import build_mil_model as jbuild
    from idee_tpu.kernels import runtime
    from idee_tpu.train import state as jstate

    return SimpleNamespace(jax=jax, jnp=jax.numpy, cfg=jax_mil_config,
                           driver=jdriver, build=jbuild, runtime=runtime,
                           state=jstate)


def test_deepmil_swin_train_step_at_delta_t_4_matches_jax(mil_jx):
    """One DeepMIL train step over Swin_3D at delta_t 4, whose stage 1
    shrinks its (8, 1, 1) window to (4, 1, 1): the loss, the vote sums,
    the step-1 gradients and the parameters after the step against JAX's
    (tests/test_torch_baselines_mil.py's helpers and tolerances). The
    composite VQModel has no such run: its CNN_3D classifier collapses
    T = 8 to 1 by three stride-2 convolutions, in JAX and the reference
    alike (idee_tpu/nn/classifier.py:6-9)."""
    from test_torch_baselines_mil import (FAR_SHARE, T_LINE, _close_after_adam,
                                          _jax_steps, _port_model, _tiny)
    jx = mil_jx
    kw = _tiny(encoder="Swin_3D", delta_t=4, en_depths=[2, 1])
    jmodel = jx.build(jx.cfg(**kw), "deepmil")
    init = jx.jax.jit(lambda a: jmodel.init(
        {"params": jx.jax.random.PRNGKey(2)}, a, train=False))(
        jx.jnp.zeros((2, V, 1, 4, 16, 16), jx.jnp.float32))
    rng = np.random.default_rng(2)
    variables = {"params": jx.jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), init["params"])}
    table = variables["params"]["encoder"]["stage1"]["block0"]["attn"][
        "relative_position_bias_table"]
    assert table.shape[1] == 7  # the (4, 1, 1) window's 2 * 4 - 1
    batch = {"x": rng.normal(size=(2, V, 1, 4, 16, 16)).astype(np.float32),
             "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.3).astype(
                 np.float32),
             "timestep": np.array([[4.0], [5.0]], np.float32)}
    jx.runtime.set_force_pallas(True)
    try:
        want_losses, want_votes, want, want_grads = _jax_steps(
            jx, kw, "deepmil", variables, [batch])
    finally:
        jx.runtime.set_force_pallas(False)

    cfg, model = _port_model(kw, "deepmil", variables)
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    metrics = init_mil_metrics((V, T_LINE, 16, 16), "cpu")
    make_mil_train_step(model, cfg, "deepmil", t0=1.0)(
        state, metrics, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss_sum"].item(), want_losses[0],
                               rtol=1e-5)
    assert int(metrics["vote_cnt"].sum()) == 2 * 4
    np.testing.assert_array_equal(metrics["vote_sum"].numpy(), want_votes[0])
    wg = flax_to_state_dict(want_grads, model.state_dict())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wg[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    got_sd = model.state_dict()
    want_sd = flax_to_state_dict(want, got_sd)
    assert sorted(got_sd) == sorted(want_sd)
    far = sum(_close_after_adam(got_sd[k], w, cfg.lr)
              for k, w in want_sd.items())
    assert far <= FAR_SHARE * sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------- patches

@pytest.mark.parametrize("patch_norm", [False, True])
@pytest.mark.parametrize("shape", [(1, 4, 8, 8, 2), (2, 3, 6, 7, 2)])
def test_patch_embed3d_matches_jax(jx, patch_norm, shape):
    kw = dict(patch_size=(2, 4, 4), embed_dim=8, patch_norm=patch_norm)
    x = _x(shape)
    jmod = jx.sw.PatchEmbed3D(**kw)
    p = _flax(jx, jmod, x)
    port = _port(swin3d.PatchEmbed3D(shape[-1], **kw), p)
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))


@pytest.mark.parametrize("shape", [(1, 1, 5, 7), (2, 2, 5, 7), (1, 3, 6, 3)])
def test_packed_patch_merging_matches_jax(jx, shape):
    x = _x(shape + (V * DIM,))
    jmod = jx.sw.PackedPatchMerging(n_groups=V, dim=DIM)
    p = _flax(jx, jmod, x)
    port = _port(swin3d.PackedPatchMerging(V, DIM), p)
    got = port(torch.from_numpy(x))
    assert got.shape[-1] == V * 2 * DIM
    _close(got, _apply(jx, jmod, p, x))
