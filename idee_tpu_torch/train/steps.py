# ------------------------------------------------------------------
"""Train and eval steps with device-resident epoch metrics (counterpart of
idee_tpu/train/steps.py; reference training and validation loops,
train_synthetic.py:170-282).

Everything the evaluators need accumulates on the device across the epoch:
the extreme-evaluator counters (evaluator_synthetic semantics), the loss
component sums, and the anomaly majority-vote timeline as a [V, T, H, W]
vote-sum buffer plus a [T] coverage counter. Nothing in a step waits for
the device, so the host runs ahead and stages the next batch while the
card works; ``metrics_to_host`` is the one sync per epoch.
"""
# ------------------------------------------------------------------

import contextlib
import gc
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import average_gradients, is_active
from idee_tpu_torch.kernels import selective_scan, window_attention
from idee_tpu_torch.utils import spans

_LOSS_KEYS = ("loss", "loss_bce", "loss_anomaly", "loss_var", "loss_z_q")
_COUNT_KEYS = ("correct", "seen", "iou_de", "predicted", "seen_all")


def _bce_kwargs(cfg: Config) -> Dict[str, Any]:
    return {"weighting": cfg.bce_weighting, "weight_cap": cfg.bce_weight_cap,
            "focal_gamma": cfg.bce_focal_gamma}


def extreme_counts(pred_c, gt) -> Dict[str, torch.Tensor]:
    """Streaming counters for evaluator_synthetic
    (reference: utils/utils_train.py:339-347). pred_c/gt: [N, 1, H, W]."""
    pred1 = pred_c == 1
    gt1 = gt == 1
    return {
        "correct": (pred1 & gt1).sum(),
        "seen": gt1.sum(),
        "iou_de": (pred1 | gt1).sum(),
        "predicted": pred1.sum(),
        # a host int: a scalar tensor made on the card would sync the host
        "seen_all": gt.numel(),
    }


def init_epoch_metrics(anomaly_shape: Tuple[int, int, int, int],
                       device) -> Dict[str, Any]:
    """Device-resident epoch accumulator; anomaly_shape = [V, T, H, W]
    (the dataset's full timeline)."""
    V, T, H, W = anomaly_shape
    return {
        "counts": {k: torch.zeros((), dtype=torch.int64, device=device)
                   for k in _COUNT_KEYS},
        "loss_sums": {k: torch.zeros((), dtype=torch.float32, device=device)
                      for k in _LOSS_KEYS},
        "n_steps": torch.zeros((), dtype=torch.int64, device=device),
        # each timeline slot is covered by at most delta_t windows per
        # epoch, and delta_t << 255
        "vote_sum": torch.zeros((V, T, H, W), dtype=torch.uint8,
                                device=device),
        "vote_cnt": torch.zeros((T,), dtype=torch.int32, device=device),
    }


def _scatter_votes(vote_sum, vote_cnt, anomaly, t_index, delta_t: int):
    """Add each sample's time-reversed [V, dt, H, W] anomaly bits onto the
    absolute timeline at [t_index - dt + 1, t_index], in place
    (anomaly_collector.__call__ semantics, utils/utils_train.py:547-554).
    anomaly [N, V, dt, H, W]; t_index [N] int64 on the device. Under the
    space axis ``anomaly`` holds the rank's H rows, which go to their rows
    of the global buffer, and the first rank of the space row alone
    counts the coverage (the ranks' buffers are summed)."""
    if delta_t > 255:
        raise ValueError("uint8 vote_sum would overflow; widen the dtype")
    N, V, dt, H, W = anomaly.shape
    chrono = anomaly.flip(2).to(vote_sum.dtype)  # chronological order
    idx = ((t_index - (delta_t - 1))[:, None]
           + torch.arange(delta_t, device=t_index.device)).reshape(-1)
    ctx = spatial.active()
    if ctx is not None:
        vote_sum = vote_sum.narrow(2, ctx.lo, ctx.rows)
    vote_sum.index_add_(1, idx, chrono.transpose(0, 1).reshape(
        V, N * dt, H, W))
    if ctx is None or ctx.s == 0:
        vote_cnt.index_add_(0, idx,
                            torch.ones_like(idx, dtype=vote_cnt.dtype))


def _accumulate(metrics, comps, out, batch, t0: float, delta_t: int,
                threshold: float = 0.5):
    """Fold one step's outputs into the epoch metrics, in place; returns
    the extreme probability sigmoid(z) and its prediction, [N, 1, H, W]
    (the ``accumulate`` span)."""
    with spans.span("accumulate", out.z.device):
        pred = torch.sigmoid(out.z)
        pred_c = (pred > threshold).float()
        counts = extreme_counts(pred_c, batch["mask_extreme"][:, None])
        for k in _COUNT_KEYS:
            metrics["counts"][k] += counts[k]
        for k in _LOSS_KEYS:
            metrics["loss_sums"][k] += comps[k]
        metrics["n_steps"] += 1
        t_index = (batch["timestep"][:, 0] - t0).long()
        _scatter_votes(metrics["vote_sum"], metrics["vote_cnt"],
                       out.anomaly, t_index, delta_t)
    return pred, pred_c


def _lambda_schedule(cfg: Config, steps_per_epoch: int):
    """lambda_anomaly at a step count: constant, or with the anomaly-L1
    curriculum (cfg.anomaly_warmup_epochs / anomaly_ramp_epochs) ramped
    linearly from 0 over the ramp epochs after the warmup ones. None when
    constant."""
    warm = cfg.anomaly_warmup_epochs * steps_per_epoch
    ramp = max(cfg.anomaly_ramp_epochs * steps_per_epoch, 1)
    if not (warm > 0 or cfg.anomaly_ramp_epochs > 0):
        return None
    return lambda step: cfg.lambda_anomaly * min(max((step - warm) / ramp,
                                                     0.0), 1.0)


def backward_and_update(model, state, loss, device) -> None:
    """zero_grad and the backward of ``loss``, under a data-parallel mesh
    the gradients averaged over the ranks (parallel/mesh.py), then
    ``state.update()`` (the optimizer step at the lr already set): the
    ``backward``, ``grad_sync`` and ``optimizer`` spans."""
    with spans.backward(device):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if is_active():
        with spans.span("grad_sync", device):
            average_gradients(model.parameters())
    with spans.span("optimizer", device):
        state.update()


def _train_body(model, cfg: Config, t0: float):
    """body(state, metrics, batch, lam): forward with train=True and the
    mask, total_loss_synthetic at lambda_anomaly ``lam`` (a float or a
    device scalar), backward, under a data-parallel mesh the gradients
    averaged over the ranks (parallel/mesh.py), ``state.update()`` (the
    optimizer step at the lr already set), then the metric updates on
    detached outputs. No host state moves and nothing waits for the
    device, so a CUDA graph can capture it, under an NCCL mesh with its
    collectives."""
    bce = _bce_kwargs(cfg)

    def body(state, metrics, batch, lam):
        # no module reads .training (train= is explicit); set for clarity
        model.train()
        dev = batch["x"].device
        out = model(batch["x"], train=True,
                    mask_extreme_loss=batch["mask_extreme_loss"],
                    generator=state.generator)
        with spans.span("loss", dev):
            loss, comps = losses.total_loss_synthetic(
                out, batch["mask_extreme"], batch["mask_extreme_loss"], lam,
                **bce)
        backward_and_update(model, state, loss, dev)
        with torch.no_grad():
            _accumulate(metrics, {k: v.detach() for k, v in comps.items()},
                        out, batch, t0, cfg.delta_t)

    return body


def make_train_step(model, cfg: Config, t0: float = 0.0,
                    steps_per_epoch: int = 0):
    """step(state, metrics, batch) -> (state, metrics): forward with
    train=True and the mask, total_loss_synthetic, backward, one optimizer
    step, then the metric updates on detached outputs (JAX
    ``_train_step_body``). Nothing waits for the device. A stateful
    codebook (VQ-EMA, k-means init, expiry) quantizes with the state it
    finds and moves its buffers in the forward, drawing from
    ``state.generator``: JAX's "codebook" collection, kept after the
    update.

    t0: absolute timestep of the dataset's first timeline slot.
    steps_per_epoch enables the anomaly-L1 curriculum
    (cfg.anomaly_warmup_epochs / anomaly_ramp_epochs): lambda_anomaly ramps
    linearly from 0 over the ramp epochs after the warmup ones."""
    lam_at = _lambda_schedule(cfg, steps_per_epoch)
    body = _train_body(model, cfg, t0)

    def step(state, metrics, batch):
        lam = cfg.lambda_anomaly if lam_at is None else lam_at(state.step)
        state.set_lr(state.schedule(state.step))
        with spans.span("step", batch["x"].device):
            body(state, metrics, batch, lam)
        state.step += 1
        return state, metrics

    return step


def _eval_body(model, cfg: Config, t0: float):
    """body(metrics, batch) -> (pred, pred_c, out): one forward of
    ``model`` in eval mode, the loss and the metric updates on the device
    (call it under inference_mode)."""
    bce = _bce_kwargs(cfg)

    def body(metrics, batch):
        model.eval()
        out = model(batch["x"], train=False,
                    mask_extreme_loss=batch["mask_extreme_loss"])
        with spans.span("loss", batch["x"].device):
            _, comps = losses.total_loss_synthetic(
                out, batch["mask_extreme"], batch["mask_extreme_loss"],
                cfg.lambda_anomaly, **bce)
        pred, pred_c = _accumulate(metrics, comps, out, batch, t0,
                                   cfg.delta_t)
        return pred, pred_c, out

    return body


def make_eval_step(model, cfg: Config, t0: float = 0.0,
                   return_preds: bool = False):
    """step(metrics, batch) -> metrics, or (metrics, preds) with
    ``return_preds`` (preds: the extreme probability "pred" and prediction
    "pred_c" [N, 1, H, W], the anomaly bits [N, V, T, H, W]; JAX's
    make_eval_step(return_preds=True)): one forward of ``model`` in eval
    mode under inference_mode, with the loss and the metric updates on the
    device. t0: absolute timestep of the dataset's first timeline slot."""
    body = _eval_body(model, cfg, t0)

    @torch.inference_mode()
    def step(metrics, batch):
        with spans.span("step", batch["x"].device):
            pred, pred_c, out = body(metrics, batch)
        if return_preds:
            return metrics, {"pred": pred, "pred_c": pred_c,
                             "anomaly": out.anomaly}
        return metrics

    return step


# ---------------------------------------------------------------- fused epochs

# eager steps of the first epoch before its capture: the kernels are built
# and loaded, cuDNN and cuBLAS pick their algorithms and workspaces, Swin's
# mask and index cache is filled and a VQ codebook's lazy k-means runs (in
# the first training step) while nothing is captured. They are steps of the
# epoch, so none is repeated.
WARMUP_STEPS = 3

# the kernel modules' launch counters; a captured step counts its launches
# once per replay (FusedEpoch.run)
_COUNTERS = (selective_scan.launches, window_attention.launches)


def _snapshot() -> Tuple[Dict[str, int], ...]:
    return tuple(dict(c) for c in _COUNTERS)


def zero_metrics(metrics) -> None:
    """Every buffer of an epoch metrics tree set to 0, in place."""
    for v in metrics.values():
        if isinstance(v, dict):
            zero_metrics(v)
        else:
            v.zero_()


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector paused. An earlier epoch's graph
    that only a reference cycle keeps (a FusedEpoch and its step's
    closure) is freed when the collector next runs; CUDA permits no graph
    destruction while a stream captures, so a collection inside a capture
    would make the capture fail."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


class FusedEpoch:
    """One step ``body()`` run over every batch of an epoch of a device
    loader (data/device.py), the batch read from the epoch's order and flip
    bits in static device buffers at a device position that the step
    advances (JAX's one jitted lax.scan per epoch). ``metrics``: the
    device buffers the body accumulates into, zeroed at each epoch.
    ``per_step``: a scalar schedule of the train step count (the anomaly-L1
    curriculum's lambda), whose values for the epoch's steps go up to the
    device with the order (``step_value()`` reads the current one).

    On a card the step is captured once as a ``torch.cuda.CUDAGraph``,
    after the first WARMUP_STEPS steps of the first epoch ran eagerly on the
    capture's side stream, and replayed once per remaining batch; later
    epochs only replay. A capture that fails raises: there is no fallback
    to eager steps. The train state's generator (dropout, drop-path,
    codebook draws) is registered with the graph, so each replay draws new
    bits. A kernel wrapper counts its launch when its Python runs, which
    under a graph is once, at the capture: the capture's counts are taken
    back and the step's launches are credited at every replay. Capture
    after any checkpoint restore: a restore replaces the optimizer's state
    tensors that the graph reads.

    Under a data-parallel mesh (parallel/mesh.py) the order and flip
    buffers hold the global batches, as the loader draws them, and each
    rank's step builds its rows of them (``rows``); the step's collectives
    (the losses' normalisers, the codebooks' statistics, the gradient
    average) are captured with it and run at every replay, on every rank
    in the same sequence. The warm-up steps run each of them first, so
    NCCL's communicator exists before the capture. Under a space axis the
    loader gathers the rank's H rows of those rows (data/device.py) and
    the body's forward and backward run the halo and shift exchanges
    (parallel/spatial.py) of the spatial context active around the epoch,
    captured as the other collectives are; the epoch metrics hold the
    rank's rows until the driver reduces them after the epoch.

    Each step is the ``step`` span and its batch the ``data`` span
    (utils/spans.py): on a card their device marks are captured with the
    step, so every replay emits them. The epoch's host work runs in the
    host ranges ``order``, ``upload``, ``zero`` and ``replays``.

    On the CPU the same body runs eagerly, step after step.
    """

    def __init__(self, loader, body, metrics, inference: bool = False,
                 per_step=None):
        self.loader = loader
        self.body = body
        self.metrics = metrics
        self.inference = inference
        self.per_step = per_step
        self.state = None
        dev = loader.device
        nb, B = len(loader), loader.batch_size
        self.device = dev
        self.order = torch.zeros((nb, B), dtype=torch.int64, device=dev)
        self.flips = (torch.zeros((nb, B, 3), dtype=torch.bool, device=dev)
                      if loader.is_aug else None)
        self.values = (torch.zeros(nb, dtype=torch.float32, device=dev)
                       if per_step is not None else None)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        mesh = getattr(loader, "mesh", None)
        self.rows = slice(None) if mesh is None else mesh.rows(B)
        self.graph = None
        self.per_replay: Tuple[Dict[str, int], ...] = ()
        self.warm_steps = 0
        self.capture_s = 0.0

    def batch(self) -> Dict[str, torch.Tensor]:
        """The rank's rows of the batch at the device position (no host
        read; the ``data`` span)."""
        with spans.span("data", self.device):
            idx = self.order.index_select(0, self.pos)[0]
            flips = (None if self.flips is None
                     else self.flips.index_select(0, self.pos)[0][self.rows])
            return self.loader.batch(idx[self.rows], flips)

    def batch_at(self, b: int) -> Dict[str, torch.Tensor]:
        """The rank's rows of the last epoch's batch ``b`` (-1: its last),
        built eagerly from its order and flip bits."""
        flips = None if self.flips is None else self.flips[b, self.rows]
        return self.loader.batch(self.order[b, self.rows], flips)

    def step_value(self) -> torch.Tensor:
        """``per_step`` at the device position, a device scalar."""
        return self.values.index_select(0, self.pos)[0]

    def _step(self):
        mode = (torch.inference_mode() if self.inference
                else contextlib.nullcontext())
        with mode, spans.span("step", self.device):
            self.body()
            self.pos += 1

    def _capture(self, stream):
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        if self.state is not None and \
                self.state.generator.device.type == "cuda":
            graph.register_generator_state(self.state.generator)
        t0 = time.perf_counter()
        with _collector_paused(), torch.cuda.graph(graph, stream=stream):
            self._step()
        self.capture_s = time.perf_counter() - t0
        after = _snapshot()
        self.per_replay = tuple(
            {k: a[k] - b[k] for k in a if a[k] != b[k]}
            for a, b in zip(after, before))
        for c, b in zip(_COUNTERS, before):
            c.update(b)
        self.graph = graph

    def __call__(self, state=None):
        """One epoch: uploads the loader's next order and flips, zeros the
        metrics, runs every batch and returns the metrics. With a train
        ``state``: the lr is set once for the epoch (the schedule is
        constant within one) and ``state.step`` advances by the epoch's
        steps."""
        with spans.host_range("order"):
            order, epoch = self.loader.epoch_order()
            flips = (None if self.flips is None
                     else self.loader.epoch_flips(epoch))
        nb = order.shape[0]
        with spans.host_range("upload"):
            if state is not None:
                self.state = state
                lr = state.schedule(state.step)
                if state.schedule(state.step + nb - 1) != lr:
                    raise ValueError("the lr schedule changes inside an "
                                     "epoch: the fused epoch sets it once "
                                     "per epoch")
                state.set_lr(lr)
                if self.values is not None:
                    self.values.copy_(torch.tensor(
                        [self.per_step(state.step + b) for b in range(nb)]))
            self.order.copy_(torch.from_numpy(order))
            if flips is not None:
                self.flips.copy_(torch.from_numpy(flips))
            self.pos.zero_()
        with spans.host_range("zero"):
            zero_metrics(self.metrics)
        self._run(nb)
        if state is not None:
            state.step += nb
        return self.metrics

    def _run(self, nb: int):
        if self.device.type != "cuda":
            for _ in range(nb):
                self._step()
            return
        done = 0
        if self.graph is None:
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                while self.warm_steps < WARMUP_STEPS and done < nb:
                    self._step()
                    done += 1
                    self.warm_steps += 1
            torch.cuda.current_stream(self.device).wait_stream(stream)
            if done == nb:
                return  # captured in the next epoch
            self._capture(stream)
        with spans.host_range("replays"):
            for _ in range(nb - done):
                self.graph.replay()
                for c, d in zip(_COUNTERS, self.per_replay):
                    for k, n in d.items():
                        c[k] += n


def make_train_epoch(model, cfg: Config, loader, anomaly_shape,
                     t0: float = 0.0, steps_per_epoch: int = 0):
    """Fused train epoch over the device loader ``loader`` (JAX
    ``make_train_epoch``, idee_tpu/train/steps.py:182-243): epoch(state) ->
    metrics, a FusedEpoch of the train step's body: on a card one CUDA
    graph replay per step. With the curriculum the epoch's per-step
    lambda_anomaly goes up to the device with the order. The metrics are
    this epoch's, in buffers the FusedEpoch owns: read them before the
    next epoch. anomaly_shape: [V, T, H, W] of the loader's dataset."""
    lam_at = _lambda_schedule(cfg, steps_per_epoch)
    body = _train_body(model, cfg, t0)

    def step():
        lam = cfg.lambda_anomaly if lam_at is None else fused.step_value()
        body(fused.state, fused.metrics, fused.batch(), lam)

    fused = FusedEpoch(loader, step,
                       init_epoch_metrics(anomaly_shape, loader.device),
                       per_step=lam_at)
    return fused


def make_eval_epoch(model, cfg: Config, loader, anomaly_shape,
                    t0: float = 0.0):
    """Fused validation epoch (JAX ``make_eval_epoch``,
    idee_tpu/train/steps.py:262-301): epoch() -> metrics, a FusedEpoch of
    the eval step's body under inference_mode (see make_train_epoch)."""
    body = _eval_body(model, cfg, t0)
    fused = FusedEpoch(loader, lambda: body(fused.metrics, fused.batch()),
                       init_epoch_metrics(anomaly_shape, loader.device),
                       inference=True)
    return fused


def metrics_to_host(metrics) -> Dict[str, Any]:
    """The epoch metrics as numpy (the one device sync per epoch)."""
    with spans.host_range("metrics_to_host"):
        return _to_numpy(metrics)


def _to_numpy(metrics):
    if isinstance(metrics, dict):
        return {k: _to_numpy(v) for k, v in metrics.items()}
    return metrics.cpu().numpy() if isinstance(metrics, torch.Tensor) \
        else np.asarray(metrics)
