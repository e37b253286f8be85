# ------------------------------------------------------------------
"""The ``space`` mesh axis's pieces (parallel/mesh.py, parallel/spatial.py)
on the CPU: the H split, the shifted-window mask cut to a rank's windows,
and the halo and ring exchanges on gloo ranks (processes of
tests/torch_parallel_worker.py, run by test_torch_parallel.py's
``run_ranks``) against the unsharded ops.

Checked:
  * ``Mesh.h_rows``: even and uneven splits on multiples of the window
    height, the partial block on the last rank, the raise where H holds
    fewer window rows than ranks;
  * ``shift_mask_on`` cut to a rank's window rows equals those windows of
    the global mask;
  * at S = 2 (16 rows: 8 / 8) and S = 3 (16 rows on blocks of 4: 8 / 4 /
    4): ``halo_pad_h`` in both modes and
    ``roll_h`` both ways (also over an H padded on the last rank), each
    rank's output and input gradient equal to F.pad's / torch.roll's on
    the whole tensor (exact: the exchanges move values, and the gradient
    sums add the same terms);
  * the exchanges raise, on every rank alike, where a rank holds fewer
    rows than a halo or shift reads; a block raises where a rank's rows
    do not start on a window row; a convolution that would change H
    raises under the space axis.
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import GroupedConv3d
from idee_tpu_torch.nn.swin3d import (compute_shift_mask, shift_mask_on,
                                      window_geometry)
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import Mesh, make_mesh
from test_torch_parallel import run_ranks

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _splits(H, S, align):
    return [Mesh(r, S, CPU, space=S).h_rows(H, align) for r in range(S)]


def test_h_rows_split_on_window_rows():
    assert _splits(16, 2, 4) == [(0, 8), (8, 16)]
    assert _splits(16, 3, 4) == [(0, 8), (8, 12), (12, 16)]
    assert _splits(200, 4, 4) == [(0, 52), (52, 104), (104, 152),
                                  (152, 200)]
    # a partial block of windows on the last rank (it pads to 4 rows)
    assert _splits(10, 2, 4) == [(0, 8), (8, 10)]
    assert _splits(16, 3, 1) == [(0, 6), (6, 11), (11, 16)]
    # a 2 x 2 mesh: the split follows the space rank, not the data rank
    assert Mesh(3, 4, CPU, space=2).h_rows(16, 4) == (8, 16)
    assert Mesh(3, 4, CPU, space=2).rows(2) == slice(1, 2)
    with pytest.raises(ValueError, match="H 6 holds 2 rows of 4"):
        Mesh(0, 3, CPU, space=3).h_rows(6, 4)


def test_mesh_axes_and_seeds():
    # the S ranks of one data index share its seed
    a, b = Mesh(2, 4, CPU, space=2), Mesh(3, 4, CPU, space=2)
    assert a.seed(0, 5) == b.seed(0, 5) != Mesh(0, 4, CPU, space=2).seed(0, 5)
    assert Mesh(1, 2, CPU, space=2).seed(7) == 7
    with pytest.raises(ValueError, match="'data', 'space'"):
        make_mesh([1, 2], ["space", "data"], device="cpu")
    with pytest.raises(ValueError, match="'data', 'space'"):
        make_mesh([2], ["data", "space"], device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("Hp,rows", [(16, (0, 2)), (16, (2, 4)),
                                     (20, (3, 5))])
def test_shift_mask_cut_to_a_ranks_windows(Hp, rows):
    ws, ss = (2, 4, 4), (1, 2, 2)
    Dp, Wp = 4, 8
    bank, idx = compute_shift_mask(Dp, Hp, Wp, ws, ss)
    full = bank[idx].reshape(Dp // 2, Hp // 4, Wp // 4, 32, 32)
    b_cut, i_cut = shift_mask_on(Dp, Hp, Wp, ws, ss, "cpu", rows)
    want = full[:, rows[0]:rows[1]].reshape(-1, 32, 32)
    np.testing.assert_array_equal(b_cut[i_cut.long()].numpy(), want)


def _ops_jobs(S, rng):
    """A global [2, 3, 16, 5] tensor (H at dim 2) and its ops."""
    x = rng.normal(size=(2, 3, 16, 5)).astype(np.float32)
    ops = [("halo", 1, 1, "zeros"), ("halo", 1, 1, "replicate"),
           ("halo", 2, 1, "replicate"), ("halo", 0, 2, "zeros"),
           ("roll", -2, 16), ("roll", 2, 16), ("roll", 3, 20)]
    weights = []
    for op in ops:
        shape = list(x.shape)
        shape[2] = 16 + op[1] + op[2] if op[0] == "halo" else op[2]
        weights.append(rng.normal(size=shape).astype(np.float32))
    return dict(kind="ops", mesh_shape=[1, S], x=x, dim=2, align=4,
                ops=ops, weights=weights)


def _whole(job, S):
    """Each op on the whole tensor, and the gradient of the sum over the
    ranks of sum(output span * weight span)."""
    out = []
    spans = _splits(16, S, job["align"])
    for op, w in zip(job["ops"], job["weights"]):
        x = torch.from_numpy(job["x"])
        if op[0] == "roll":
            pad = torch.from_numpy(np.random.default_rng(9).normal(
                size=(2, 3, op[2] - 16, 5)).astype(np.float32))
            x = torch.cat([x, pad], 2)
        x.requires_grad_()
        if op[0] == "halo":
            _, before, after, mode = op
            y = F.pad(x, (0, 0, before, after),
                      mode="constant" if mode == "zeros" else "replicate")
            cuts = [(lo, hi - lo + before + after) for lo, hi in spans]
        else:
            y = torch.roll(x, op[1], 2)
            cuts = [(lo, (op[2] if r == S - 1 else hi) - lo)
                    for r, (lo, hi) in enumerate(spans)]
        w = torch.from_numpy(w)
        sum((y.narrow(2, lo, n) * w.narrow(2, lo, n)).sum()
            for lo, n in cuts).backward()
        out.append((y.detach(), x.grad, cuts))
    return out


@pytest.mark.parametrize("S", [2, 3])
def test_halo_and_roll_match_the_unsharded_ops(tmp_path, S):
    rng = np.random.default_rng(S)
    jobs = [_ops_jobs(S, rng)]
    # the rolls' padded rows: the same values on every rank
    for job in jobs:
        pad = np.random.default_rng(9).normal(
            size=(2, 3, 4, 5)).astype(np.float32)
        job["x"] = np.concatenate([job["x"], pad], 2)
        job["H"] = 16
    got = run_ranks(tmp_path, jobs, world=S, timeout=120)
    for j, job in enumerate(jobs):
        job = dict(job, x=job["x"][:, :, :16])
        for k, (y, grad, cuts) in enumerate(_whole(job, S)):
            for r in range(S):
                res = got[r][j][k]
                lo, n = cuts[r]
                what = f"{job['ops'][k]} rank {r}"
                np.testing.assert_array_equal(
                    res["y"].numpy(), y.narrow(2, lo, n).numpy(), what)
                rlo, rhi = res["rows"]
                np.testing.assert_allclose(
                    res["grad"].numpy(), grad[:, :, rlo:rhi].numpy(),
                    rtol=1e-6, atol=1e-6, err_msg=what)


def test_exchanges_raise_on_every_rank_for_a_short_rank():
    """The check reads the split (every rank's rows), not the local shape,
    so every rank raises before any collective."""
    for r in range(3):
        mesh = Mesh(r, 3, CPU, space=3)
        with spatial.activate(mesh, 10, 4) as ctx:  # rows 4 / 4 / 2
            x = torch.zeros(1, ctx.rows, 3)
            with pytest.raises(ValueError, match="leaves a rank 2 rows"):
                spatial.halo_pad_h(x, 1, 3, 3)
            with pytest.raises(ValueError, match="a shift of -3 rows"):
                spatial.roll_h(x, 1, -3, 10)
            # a block whose window rows the split does not follow
            with pytest.raises(ValueError, match="start on a row of win"):
                window_geometry((8, ctx.rows, 16), (2, 8, 4), (0, 4, 2))
            conv = GroupedConv3d(1, 1, 1, (3, 3, 3), strides=(1, 2, 1))
            with pytest.raises(ValueError, match="stride 2"):
                conv(torch.zeros(1, 4, ctx.rows, 4, 1))
    assert spatial.active() is None
