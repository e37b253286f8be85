# ------------------------------------------------------------------
"""Training under the ``space`` mesh axis on the CPU (gloo ranks, each a
process of tests/torch_parallel_worker.py): H split over the space axis,
every halo and shifted window exchanged between neighbouring ranks
(parallel/spatial.py).

The rule is JAX's (tests/test_parallel.py:81-176: a [2, 4] data x space
mesh gives the unsharded loss): a sharded train step computes the update
of the single-device step on the same global batch. Checked, with
dropout at 0 as there, 2 train steps of the tiny synthetic config (16 x
16, windows [(2,4,4),(8,1,1)]) from JAX's init of each encoder's seed:
  * Mamba, Swin_3D and CNN_3D at mesh_shape [1, 2] (8 / 8 rows), [1, 3]
    (uneven: 8 / 4 / 4 rows for the windowed encoders, 6 / 5 / 5 for
    CNN_3D) and [2, 2] (one batch row per data index): every rank's
    parameters within atol 2e-5 of the port's world-1 run and of JAX's
    single-device steps, the global losses within rtol 2e-4, the ranks
    holding one model;
  * at [1, 2] the epoch counters and vote buffers, summed over the ranks,
    equal world 1's, and each rank launches the kernels world 1 launches
    (through the plain versions here: the counters count card launches).
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch

from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params)
from idee_tpu_torch.parallel.mesh import Mesh
from idee_tpu_torch.parallel.spatial import model_row_align
from test_torch_parallel import (LOSS_RTOL, _close, _world1_steps,
                                 run_ranks)
from test_torch_train import (_batches, _jax_params, _jax_trajectory,
                              _tiny_config, jx)  # noqa: F401

torch.set_num_threads(1)

# test_torch_train's init seeds (no ReLU input near 0 in CNN_3D)
ENCODER_SEEDS = {"Mamba": 1, "Swin_3D": 1, "CNN_3D": 2}
MESHES = {"1x2": [1, 2], "1x3": [1, 3], "2x2": [2, 2]}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def encoders(jx):
    """Each encoder's JAX init, batches, the port's world-1 steps and
    JAX's steps."""
    out = {}
    for enc, seed in ENCODER_SEEDS.items():
        cfg = _tiny_config(encoder=enc)
        _, params = _jax_params(jx, cfg, seed=seed)
        sd = load_flax_params(cfg, params)
        batches = _batches(2, seed=3)
        jx.runtime.set_force_pallas(True)
        try:
            jax_losses, jax_params, _ = _jax_trajectory(jx, cfg, params,
                                                        batches)
        finally:
            jx.runtime.set_force_pallas(False)
        world1 = _world1_steps(cfg, sd, batches)
        out[enc] = dict(cfg=cfg, state_dict=sd, batches=batches,
                        world1=world1, jax_losses=jax_losses,
                        jax_params=flax_to_state_dict(jax_params, world1[2]))
    return out


@pytest.fixture(scope="module")
def runs(encoders, tmp_path_factory):
    """Every mesh's ranks' results, by mesh and encoder."""
    out = {}
    for name, shape in MESHES.items():
        jobs = [dict(kind="steps", mesh_shape=shape, cfg=e["cfg"].to_dict(),
                     state_dict=e["state_dict"], batches=e["batches"])
                for e in encoders.values()]
        got = run_ranks(tmp_path_factory.mktemp(f"space{name}"), jobs,
                        world=int(np.prod(shape)), timeout=240)
        out[name] = {enc: [r[i] for r in got]
                     for i, enc in enumerate(encoders)}
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("encoder", list(ENCODER_SEEDS))
def test_sharded_steps_match_world_1_and_jax(encoders, runs, mesh, encoder):
    want = encoders[encoder]
    w1_losses, _, w1_sd = want["world1"]
    ranks = runs[mesh][encoder]
    S, align = MESHES[mesh][1], model_row_align(want["cfg"])
    for r, got in enumerate(ranks):
        # the rank held its H rows of the split
        assert tuple(got["rows"]) == Mesh(r, len(ranks), CPU, space=S
                                          ).h_rows(16, align)
        np.testing.assert_allclose(got["losses"], w1_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], want["jax_losses"],
                                   rtol=LOSS_RTOL)
        _close(got["state_dict"], w1_sd, f"{mesh} rank {r} against world 1")
        _close({k: got["state_dict"][k] for k in want["jax_params"]},
               want["jax_params"], f"{mesh} rank {r} against JAX")
    for k, v in ranks[0]["state_dict"].items():
        for got in ranks[1:]:
            assert torch.equal(v, got["state_dict"][k]), k


def test_uneven_split_is_the_window_rows():
    """[1, 3] splits 16 rows on the windows' 4-row blocks (8 / 4 / 4) for
    the windowed encoders and row by row (6 / 5 / 5) for CNN_3D."""
    for enc, want in (("Mamba", [8, 4, 4]), ("Swin_3D", [8, 4, 4]),
                      ("CNN_3D", [6, 5, 5])):
        align = model_row_align(_tiny_config(encoder=enc))
        got = [hi - lo for lo, hi in (
            Mesh(r, 3, CPU, space=3).h_rows(16, align)
            for r in range(3))]
        assert got == want, enc


@pytest.mark.parametrize("encoder", list(ENCODER_SEEDS))
def test_counts_votes_and_launches_equal_world_1(encoders, runs, encoder):
    _, w1_metrics, _ = encoders[encoder]["world1"]
    ranks = runs["1x2"][encoder]
    for got in ranks:
        for m, w in zip(got["metrics"], w1_metrics):
            assert int(m["counts"]["seen_all"]) == 2 * 16 * 16
            for k, v in w["counts"].items():
                assert int(m["counts"][k]) == int(v), k
            np.testing.assert_array_equal(m["vote_sum"],
                                          w["vote_sum"].numpy())
            np.testing.assert_array_equal(m["vote_cnt"],
                                          w["vote_cnt"].numpy())
        # on the CPU the wrappers run their plain versions: no launch
        assert got["launches"] == {}
