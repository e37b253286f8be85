# ------------------------------------------------------------------
"""Data and spatial parallelism over several GPUs (counterpart of
idee_tpu/parallel/mesh.py: the ``data`` axis, :19-38, and the ``space``
axis, :46-76).

JAX shards the global batch over the mesh's ``data`` axis and lets GSPMD
insert the collectives, so its sharded step computes the update of the
single-device step on the same global batch. Here one process runs per
rank (``torchrun --nproc_per_node N``), each on ``cfg.batch_size / N``
rows of every global batch, and the step is made to compute that same
update:

* the loaders draw the epoch's order and every augmentation for the
  whole global batch, in the single-device order, and build only the
  rank's rows (``Mesh.rows``), so the ranks' rows together are the
  world-1 batch;
* every batch-wide normaliser of the losses (a class histogram, a
  valid-pixel count, the codebook entropy's batch means) is taken over
  the global batch. A rank's loss is its share of the global loss scaled
  by the world size, so that the mean of the ranks' gradients, which
  ``average_gradients`` takes after the backward, is the global gradient;
* the codebook statistics (k-means bins and sums, the EMA's counts and
  sums) are summed over the ranks, and rows sampled from the batch
  (k-means seeds, dead-code replacements) are drawn once, by rank 0, over
  the global batch;
* the evaluator counters and the vote buffers are summed over the ranks
  at each epoch's end (``reduce_metrics``), the loss sums averaged.

The gradients are all-reduced explicitly after the backward rather than
by ``DistributedDataParallel``'s hooks during it: the losses' own
all-reduces (the codebook entropy's, in its backward) then never
interleave with the gradient buckets, parameters that get no gradient
(a frozen LFQ projection) and block recompute (``en_use_checkpoint``)
need no special mode, and the model stays the unwrapped module whose
state_dict the checkpoints and the interop read.

Randomness: each rank draws dropout, drop-path and codebook noise from
its own generator, seeded from (cfg.seed, rank) (``seed``); rank 0 keeps
cfg.seed, so a world of one draws what the single-device path draws. No
two ranks share bits, so with dropout on the ranks' rows see other masks
than the world-1 batch's: the equality with world 1 holds with dropout
at 0, as in JAX's own test (tests/test_parallel.py:40-65).

The fused epochs (train/steps.py::FusedEpoch) run under a mesh too: on a
card their captured step holds these collectives, which NCCL can capture
in a CUDA graph and gloo cannot (``check_fused_epochs``). None of the
helpers reads a value back to the host or sizes a tensor from one, so a
replay repeats exactly the collectives of its capture.

The ``space`` axis: ``mesh_shape [D, S]`` over ``mesh_axes ["data",
"space"]`` (rank ``d * S + s``, the row-major order of JAX's make_mesh)
splits each sample's H over the S ranks of its data index ``d``
(``Mesh.h_rows``), as JAX's ``spatial_sharding`` does. Where JAX's
spatial partitioner inserts the halo exchanges, the port's modules call
parallel/spatial.py's explicit ones over the rank's space group. A rank
holds its data rows' batch rows and its H rows of every leaf, so the
shares of the ranks are unequal where H does not split evenly: every
batch mean is then the global sum over the global count (``batch_mean``,
``grad_batch_mean``). The S ranks of one data index draw the same
dropout and drop-path values: their generators start from the data
coordinate (``seed``) and each draws at the global shape, keeping its
rows (nn/layers.py).

Without a mesh nothing here runs: every module-level helper returns its
input, so the single-device path starts no process group and makes no
collective call.
"""
# ------------------------------------------------------------------

import math
import os
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from idee_tpu_torch import resolve_device

# the mesh of this process, set by make_mesh and cleared by Mesh.close
_ACTIVE: Optional["Mesh"] = None


@dataclass
class Mesh:
    """This process's place on the mesh: its rank, the world size, its
    device, and with a ``space`` axis of ``space`` ranks the process group
    of its space row (the ranks of its data index)."""

    rank: int
    world: int
    device: torch.device
    started: bool = False  # make_mesh started the process group
    backend: str = "gloo"
    space: int = 1
    space_group: Any = None  # None at space 1

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes files."""
        return self.rank == 0

    @property
    def data(self) -> int:
        """The ``data`` axis's size."""
        return self.world // self.space

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space

    @property
    def space_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's space row, in space order."""
        first = self.data_rank * self.space
        return tuple(range(first, first + self.space))

    def rows(self, n: int) -> slice:
        """The rank's rows of a global batch of ``n`` (its data index's)."""
        if n % self.data:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.data} ranks of the data axis")
        b = n // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def h_rows(self, H: int, align: int = 1) -> Tuple[int, int]:
        """The rank's global rows [lo, hi) of an H of ``H`` on the space
        axis: split on multiples of ``align`` (the model's window height,
        ``spatial.model_row_align``), as evenly as ``align`` allows, the first
        ranks taking the extra blocks (200 rows at S=4, align 4: 52, 52,
        48, 48); the last rank ends at H (a partial block, which the
        windowed blocks pad). Raises when H has fewer blocks than
        ranks."""
        S, s = self.space, self.space_rank
        blocks = -(-H // align)
        if blocks < S:
            raise ValueError(
                f"H {H} holds {blocks} rows of {align} (the window height) "
                f"and cannot split over {S} ranks of the space axis")
        base, extra = divmod(blocks, S)
        lo = s * base + min(s, extra)
        hi = lo + base + (s < extra)
        return lo * align, min(hi * align, H)

    def seed(self, seed: int, step: int = 0) -> int:
        """The seed of the rank's generator: ``seed`` itself on data index
        0 at step 0, else a draw of numpy's SeedSequence over (seed, data
        index, step). The S ranks of a data index share it."""
        d = self.data_rank
        if d == 0 and step == 0:
            return seed
        return int(np.random.SeedSequence(
            [seed, d, step]).generate_state(1)[0])

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (no gradient)."""
        dist.all_reduce(t)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the ranks, in place (no gradient): one AVG
        all-reduce under NCCL, a sum then a division under gloo (which has
        no AVG)."""
        if self.backend == "nccl":
            dist.all_reduce(t, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(t)
            t /= self.world
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` replaced by rank ``src``'s, in place."""
        dist.broadcast(t, src)
        return t

    def sync_generator(self, generator: torch.Generator) -> None:
        """Every rank of the space row takes the state of its first rank's
        ``generator`` (the identity at space 1)."""
        if self.space == 1:
            return
        state = generator.get_state()
        t = state.to(self.device) if self.backend == "nccl" else state
        dist.broadcast(t, self.space_ranks[0], group=self.space_group)
        generator.set_state(t.cpu())

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Every parameter and buffer of ``module`` from rank 0."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast_(t.data)

    def average_gradients(self, params: Iterable[torch.nn.Parameter]):
        """Each gradient replaced by its mean over the ranks, in one
        all-reduce of the flattened gradients. A parameter without a
        gradient is left without one (the ranks run the same graph, so
        they agree on which)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = self.mean_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n

    def reduce_metrics(self, metrics):
        """An epoch metrics tree (train/steps.py, steps_real.py) made
        global, in place: counters and vote buffers summed over the ranks,
        loss sums averaged (each rank's loss already is its share of the
        global loss, scaled by the world size), the step count kept."""
        for k, v in metrics.items():
            if isinstance(v, dict):
                for t in v.values():
                    self._reduce(t, average=(k == "loss_sums"))
            elif k != "n_steps":
                self._reduce(v, average=False)
        return metrics

    def _reduce(self, t: torch.Tensor, average: bool):
        # the vote sums are uint8: summed in int32, which every backend
        # reduces
        w = t if t.dtype in (torch.float32, torch.int64, torch.int32) \
            else t.to(torch.int32)
        dist.all_reduce(w)
        if average:
            w /= self.world
        if w is not t:
            t.copy_(w)

    def close(self) -> None:
        """Destroy the process group; the helpers turn back into the
        identity."""
        global _ACTIVE
        if dist.is_initialized():
            dist.destroy_process_group()
        if _ACTIVE is self:
            _ACTIVE = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_mesh(mesh_shape: Sequence[int], mesh_axes: Sequence[str] = ("data",),
              device=None, backend: Optional[str] = None,
              init_method: str = "env://") -> Mesh:
    """The mesh of this process, from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; a process started without torchrun is
    rank 0 of 1): ``mesh_shape [D]`` over ``["data"]``, or ``[D, S]`` over
    ``["data", "space"]`` (rank ``d * S + s``; one process group per space
    row for the halo exchanges). Starts the process group once (a started
    one is kept): ``backend`` ``nccl`` on a card, ``gloo`` on the CPU,
    unless named (two ranks on one card need gloo). ``device``:
    ``cuda:LOCAL_RANK`` unless given (a bare ``cuda`` also takes the local
    rank's card). Raises on other axes or when ``mesh_shape`` is not the
    world size."""
    global _ACTIVE
    axes = list(mesh_axes)
    if axes not in (["data"], ["data", "space"]) or \
            len(mesh_shape) != len(axes):
        raise ValueError(f"mesh_shape {list(mesh_shape)} over axes {axes}: "
                         "the port shards ['data'] or ['data', 'space']")
    rank = _env_int("RANK", 0)
    world = _env_int("WORLD_SIZE", 1)
    local = _env_int("LOCAL_RANK", rank)
    if math.prod(mesh_shape) != world:
        raise ValueError(
            f"mesh_shape {list(mesh_shape)} needs {math.prod(mesh_shape)} "
            f"processes, this run has WORLD_SIZE {world} (start it with "
            f"torchrun --nproc_per_node {math.prod(mesh_shape)})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    started = not dist.is_initialized()
    if started:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world)
    S = int(mesh_shape[1]) if len(axes) == 2 else 1
    group = None
    if S > 1:
        # every rank makes every group, in the same order
        for d in range(world // S):
            g = dist.new_group(list(range(d * S, (d + 1) * S)))
            if d == rank // S:
                group = g
    _ACTIVE = Mesh(rank, world, dev, started, str(dist.get_backend()), S,
                   group)
    return _ACTIVE


def check_fused_epochs(mesh: Optional[Mesh]) -> None:
    """Raises unless the fused epochs can run under ``mesh``. On a card
    their step is captured as a CUDA graph with the step's collectives
    inside: NCCL's can be captured, gloo's (which stage CUDA tensors
    through the host) cannot. On the CPU the fused step runs eagerly, so
    any backend serves. There is no fallback to eager steps on a card."""
    if mesh is None or mesh.device.type != "cuda" or mesh.backend == "nccl":
        return
    raise ValueError(
        f"the fused epochs under a {mesh.backend} mesh on {mesh.device}: a "
        f"CUDA graph cannot capture {mesh.backend}'s collectives; use the "
        "nccl backend, or set fused_epoch=False for the per-step loop")


# -- the losses' and codebooks' collectives: the identity without a mesh


def world_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def is_active() -> bool:
    """True between make_mesh and the mesh's close."""
    return _ACTIVE is not None


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, without gradient (a copy)."""
    if _ACTIVE is None:
        return t
    return _ACTIVE.sum_(t.detach().clone())


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks, without gradient: a batch-wide
    normaliser (a count) of the global batch, per rank. A rank's loss
    divided by it is its share of the global loss scaled by the world
    size."""
    if _ACTIVE is None:
        return t
    return _ACTIVE.mean_(t.detach().clone())


def _space() -> bool:
    """A mesh with a space axis is active: the ranks' shares of a batch
    may differ in size."""
    return _ACTIVE is not None and _ACTIVE.space > 1


def _global_count(n: int, device) -> torch.Tensor:
    """The sum over the ranks of each rank's ``n`` (float32, no host read;
    filled on the device, so a CUDA graph can capture it)."""
    return sum_over_ranks(torch.full((), float(n), dtype=torch.float32,
                                     device=device))


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t``'s entries over the global batch, as the rank's
    share of it scaled by the world size (a loss term). Without a space
    axis every rank holds as many entries: the local mean. Under one, the
    rank's sum over the world's mean count."""
    if not _space():
        return t.mean()
    return t.sum() / (_global_count(t.numel(), t.device) / _ACTIVE.world)


def grad_batch_mean(*ts: torch.Tensor, dim=None) -> torch.Tensor:
    """[len(ts)]: each ``t``'s mean over ``dim`` (None: all its entries)
    across the global batch, the same on every rank and differentiable (the
    backward sums the ranks' gradients): a batch statistic of a term that
    is not linear in it (the codebook entropy). Without a space axis the
    ranks' means averaged (equal shares); under one, the global sums over
    the global count."""
    if not _space():
        return grad_mean_over_ranks(torch.stack([t.mean(dim) for t in ts]))
    from torch.distributed.nn.functional import all_reduce

    n = ts[0].numel() if dim is None else ts[0].shape[dim]
    return all_reduce(torch.stack([t.sum(dim) for t in ts])) / \
        _global_count(n, ts[0].device)


def grad_mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks, differentiably (the backward sums
    the ranks' gradients): a batch mean of the global batch from the
    ranks' means of equal-sized row sets, for a term that is not linear
    in it (the codebook entropy). Under NCCL one AVG all-reduce, whose
    backward is an AVG all-reduce too."""
    if _ACTIVE is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    if _ACTIVE.backend == "nccl":
        return all_reduce(t, op=dist.ReduceOp.AVG)
    return all_reduce(t) / _ACTIVE.world


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a copy)."""
    if _ACTIVE is None:
        return t
    return _ACTIVE.broadcast_(t.clone(), src)


def data_rows(n_local: int) -> slice:
    """The global batch rows of the rank's ``n_local`` (its data index's
    share)."""
    d = 0 if _ACTIVE is None else _ACTIVE.data_rank
    return slice(d * n_local, (d + 1) * n_local)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Each gradient averaged over the ranks (after the backward)."""
    if _ACTIVE is not None:
        _ACTIVE.average_gradients(params)
