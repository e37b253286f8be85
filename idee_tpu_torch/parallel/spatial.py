# ------------------------------------------------------------------
"""The ``space`` axis's halo and shifted-window exchanges (the port's
counterpart of what XLA's spatial partitioner inserts for JAX's
``spatial_sharding``, idee_tpu/parallel/mesh.py:46-76, and of
idee_tpu/kernels/runtime.py's ``set_spatial_mesh``).

Under ``mesh_shape [D, S]`` each rank holds the rows [lo, hi) of every
sample's H (parallel/mesh.py::Mesh.h_rows). The drivers make the active
context (``activate``): the global H, every rank's rows and the space
group. Every op that reads across a row boundary calls one of three
exchanges with the ranks of its space row:

* ``halo_pad_h(x, dim, before, after, mode)``: ``x`` with ``before``
  rows of the rank above and ``after`` rows of the rank below; at the
  global top and bottom zeros or copies of the edge row (``mode``
  "zeros" or "replicate", F.pad's two modes). Its backward sends each
  halo row's gradient back to the row it came from and adds it there.
* ``roll_h(x, dim, shift, H)``: ``torch.roll`` over a global axis of
  ``H`` rows, a ring (rank S-1's rows wrap to rank 0). Its backward is
  the opposite roll.
* ``gather_h(x, dim)``: the global tensor on every rank (no gradient),
  for what is shown whole (the image panels).

Each exchange is one collective over the space group, called in the
same order by every rank of the row (the ranks run one program, and
autograd walks their identical graphs in one order): a gather of the
edge rows, made as an ``all_reduce`` of a zeroed buffer in which each
rank fills its own slot (a sum with zeros: exact). Both backends take it
for CUDA tensors (gloo takes only ``all_reduce`` and ``broadcast`` there),
and the halos are a few rows. Nothing reads a value back to the host.

Every rank must hold at least as many rows as each halo and shift it
exchanges (only the neighbour's rows are read); the ops raise with the
geometry named where one does not, on every rank alike (the check reads
the split, not the local shape).

Without an active context every module's path is the single-device one.
"""
# ------------------------------------------------------------------

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

# the context of this process, set by ``activate``
_CTX: Optional["SpatialContext"] = None

# transported as float32 by the exchanges (exact), which gloo sums in
# every backend
_WIDEN = (torch.bfloat16, torch.float16)


@dataclass(frozen=True)
class SpatialContext:
    """Rank ``s`` of a space row of ``S`` ranks (their process ``group``)
    on a global H of ``H`` rows split into ``splits`` (every rank's [lo,
    hi))."""

    H: int
    splits: Tuple[Tuple[int, int], ...]
    s: int
    group: object

    @property
    def S(self) -> int:
        return len(self.splits)

    @property
    def lo(self) -> int:
        return self.splits[self.s][0]

    @property
    def hi(self) -> int:
        return self.splits[self.s][1]

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def least_rows(self, H: int) -> int:
        """The fewest rows of a rank on an axis of ``H`` >= self.H rows
        that extends the last rank's (a padded H)."""
        sizes = [hi - lo for lo, hi in self.splits[:-1]]
        return min(sizes + [H - self.splits[-1][0]])

    def check(self, need: int, H: int, what: str) -> None:
        """Raises unless every rank holds ``need`` rows of the axis of
        ``H`` rows."""
        if self.least_rows(H) < need:
            raise ValueError(
                f"{what} reads {need} rows of each neighbour, but H {H} "
                f"split over {self.S} ranks of the space axis as "
                f"{list(self.splits)} leaves a rank "
                f"{self.least_rows(H)} rows")


def active() -> Optional[SpatialContext]:
    """The active context, or None (the single-device path)."""
    return _CTX


def model_row_align(cfg) -> int:
    """The rows an H split of cfg's encoder falls on: the least common
    multiple of its windows' heights (Mamba, Swin_3D), so every block sees
    whole window rows; 1 for CNN_3D, which has no windows."""
    if cfg.encoder in ("Mamba", "Swin_3D"):
        return math.lcm(1, *(int(w[1]) for w in cfg.en_window_size))
    return 1


def make_context(mesh, H: int, align: int = 1) -> SpatialContext:
    """The context of ``mesh``'s rank for a global H of ``H`` rows split
    on multiples of ``align`` (``Mesh.h_rows``: raises where H cannot
    split)."""
    from dataclasses import replace

    splits = tuple(replace(mesh, rank=r).h_rows(H, align)
                   for r in mesh.space_ranks)
    return SpatialContext(H, splits, mesh.space_rank, mesh.space_group)


@contextlib.contextmanager
def activate(mesh, H: int, align: int = 1) -> Iterator[
        Optional[SpatialContext]]:
    """Within the block the context of ``mesh`` for a global H of ``H``
    rows is active (none without a mesh or a space axis); the previous
    one comes back after it."""
    global _CTX
    if mesh is None or mesh.space == 1:
        yield None
        return
    prev, _CTX = _CTX, make_context(mesh, H, align)
    try:
        yield _CTX
    finally:
        _CTX = prev


def shard_rows(batch, ctx: Optional[SpatialContext]):
    """The rank's H rows of every leaf of ndim >= 3 of ``batch`` (H at
    ndim - 2, JAX's ``spatial_sharding`` rule) under the context ``ctx``;
    leaves of fewer dims (the timestep) whole. The identity without
    one."""
    if ctx is None:
        return batch
    out = {}
    for k, v in batch.items():
        if v.ndim >= 3:
            if v.shape[-2] != ctx.H:
                raise ValueError(f"batch leaf {k} of shape {tuple(v.shape)}"
                                 f": H is not the context's {ctx.H}")
            v = v[..., ctx.lo:ctx.hi, :]
        out[k] = v
    return out


# -- the exchanges


def _all_edges(t: torch.Tensor, ctx: SpatialContext) -> torch.Tensor:
    """[S, *t.shape]: every rank's ``t`` (equal shapes) in space order."""
    wide = t.float() if t.dtype in _WIDEN else t
    buf = torch.zeros((ctx.S,) + tuple(t.shape), dtype=wide.dtype,
                      device=t.device)
    buf[ctx.s].copy_(wide)
    dist.all_reduce(buf, group=ctx.group)
    return buf.to(t.dtype)


def _edge_fill(x, dim: int, n: int, top: bool, mode: str):
    """The ``n`` rows beyond the global top (``top``) or bottom edge."""
    if mode == "replicate":
        row = x.narrow(dim, 0 if top else x.shape[dim] - 1, 1)
        return row.expand(*[n if d == dim else -1
                            for d in range(x.dim())])
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


class _HaloPad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, before, after, mode, sc):
        h = x.shape[dim]
        ctx.meta = (dim, before, after, mode, sc, h)
        # my first ``after`` rows serve the rank above, my last
        # ``before`` rows the rank below
        mine = torch.cat([x.narrow(dim, 0, after),
                          x.narrow(dim, h - before, before)], dim)
        every = _all_edges(mine, sc)
        if sc.s > 0:
            top = every[sc.s - 1].narrow(dim, after, before)
        else:
            top = _edge_fill(x, dim, before, True, mode)
        if not sc.last:
            bottom = every[sc.s + 1].narrow(dim, 0, after)
        else:
            bottom = _edge_fill(x, dim, after, False, mode)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        dim, before, after, mode, sc, h = ctx.meta
        g_top = g.narrow(dim, 0, before)
        g_bottom = g.narrow(dim, before + h, after)
        every = _all_edges(torch.cat([g_top, g_bottom], dim), sc)
        dx = g.narrow(dim, before, h).clone()
        if not sc.last:  # the rank below read my last rows
            dx.narrow(dim, h - before, before).add_(
                every[sc.s + 1].narrow(dim, 0, before))
        elif mode == "replicate":
            dx.narrow(dim, h - 1, 1).add_(g_bottom.sum(dim, keepdim=True))
        if sc.s > 0:  # the rank above read my first rows
            dx.narrow(dim, 0, after).add_(
                every[sc.s - 1].narrow(dim, before, after))
        elif mode == "replicate":
            dx.narrow(dim, 0, 1).add_(g_top.sum(dim, keepdim=True))
        return dx, None, None, None, None, None


def halo_pad_h(x: torch.Tensor, dim: int, before: int, after: int,
               mode: str = "zeros") -> torch.Tensor:
    """``x`` (the rank's rows along ``dim``) padded with ``before`` rows
    of the rank above and ``after`` of the rank below; zeros or the edge
    row (``mode`` "zeros" / "replicate") beyond the global H."""
    sc = _CTX
    if not (before or after):
        return x
    sc.check(max(before, after), sc.H, f"a halo of ({before}, {after})")
    return _HaloPad.apply(x, dim, before, after, mode, sc)


def _roll(x, dim: int, shift: int, sc: SpatialContext):
    h = x.shape[dim]
    if shift > 0:  # rows move down: the rank above's last rows come in
        every = _all_edges(x.narrow(dim, h - shift, shift), sc)
        return torch.cat([every[(sc.s - 1) % sc.S],
                          x.narrow(dim, 0, h - shift)], dim)
    m = -shift  # rows move up: the rank below's first rows come in
    every = _all_edges(x.narrow(dim, 0, m), sc)
    return torch.cat([x.narrow(dim, m, h - m), every[(sc.s + 1) % sc.S]],
                     dim)


class _RollH(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, shift, sc):
        ctx.meta = (dim, shift, sc)
        return _roll(x, dim, shift, sc)

    @staticmethod
    def backward(ctx, g):
        dim, shift, sc = ctx.meta
        return _roll(g, dim, -shift, sc), None, None, None


def roll_h(x: torch.Tensor, dim: int, shift: int, H: int) -> torch.Tensor:
    """``torch.roll(global, shift, dim)`` of a global axis of ``H`` rows
    (the context's H, or more where the last rank's rows were padded),
    on the rank's rows."""
    sc = _CTX
    if shift == 0:
        return x
    sc.check(abs(shift), H, f"a shift of {shift} rows")
    return _RollH.apply(x, dim, shift, sc)


@torch.no_grad()
def gather_h(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The global tensor of the rank's rows ``x`` (``dim`` its H, by
    default ndim - 2), on every rank of the space row; no gradient. ``x``
    itself without a context."""
    sc = _CTX
    if sc is None:
        return x
    dim = x.dim() - 2 if dim is None else dim
    wide = x.float() if x.dtype in _WIDEN or x.dtype == torch.bool else x
    shape = list(x.shape)
    shape[dim] = sc.H
    buf = torch.zeros(shape, dtype=wide.dtype, device=x.device)
    buf.narrow(dim, sc.lo, sc.rows).copy_(wide)
    dist.all_reduce(buf, group=sc.group)
    return buf.to(x.dtype)


def token_rows(idx: torch.Tensor, outer: int, h: int, inner: int,
               n_local: int, b0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global indices ``idx`` of rows laid out [B, outer, H, inner]
    (row-major) -> (the index of each in this rank's [n_local, outer, h,
    inner] rows, clamped, and whether the rank holds it). The rank holds
    batch rows [b0, b0 + n_local) and of H the context's rows, or all
    ``h`` without a context."""
    sc = _CTX
    H, lo = (h, 0) if sc is None else (sc.H, sc.lo)
    rest, i = idx.div(inner, rounding_mode="floor"), idx % inner
    rest, r = rest.div(H, rounding_mode="floor"), rest % H
    b, o = rest.div(outer, rounding_mode="floor"), rest % outer
    own = ((b >= b0) & (b < b0 + n_local) & (r >= lo) & (r < lo + h))
    local = (((b - b0) * outer + o) * h + (r - lo)) * inner + i
    n = n_local * outer * h * inner
    return local.clamp(0, n - 1), own
