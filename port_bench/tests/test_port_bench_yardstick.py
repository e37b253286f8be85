"""The yardstick's arithmetic: the roofline bounds at known shapes (the
port's bound column of PERF.md, PRs 6-18), the shapes derived from the
cells, the idle union, and the stored FLOP counts."""

import pytest

from port_bench import bounds, harness, readers, trace
from port_bench.reference import steps

MS = 1e-3
# PERF.md gives the bounds in ms to four places
HALF = 0.00005 * MS


def cell(name):
    return harness.load_cell(name)


def test_scan_bounds_at_the_bench_width_and_the_cerra_grid():
    assert bounds.fused_scan_fwd(32, 960_000) == pytest.approx(
        0.2224 * MS, abs=HALF)
    assert bounds.fused_scan_fwd(8, 3_840_000) == pytest.approx(
        0.2293 * MS, abs=HALF)
    assert bounds.fused_scan_bwd(32, 960_000) == pytest.approx(
        0.4448 * MS, abs=HALF)
    assert bounds.fused_scan_bwd(8, 3_840_000) == pytest.approx(
        0.4585 * MS, abs=HALF)
    assert bounds.fused_scan_fwd(32, 10_223_616) == pytest.approx(
        2.3682 * MS, abs=HALF)
    assert bounds.fused_scan_fwd(8, 40_894_464) == pytest.approx(
        2.4415 * MS, abs=HALF)


def test_attention_bounds():
    assert bounds.window_attention_fwd(10_000, 32, 12, 8) == pytest.approx(
        0.1467 * MS, abs=HALF)
    assert bounds.window_attention_bwd(10_000, 32, 12, 8) == pytest.approx(
        0.2568 * MS, abs=HALF)
    assert bounds.window_attention_fwd(10_000, 32, 12, 8, "bfloat16") == \
        pytest.approx(0.0734 * MS, abs=HALF)
    assert bounds.window_attention_bwd(10_000, 32, 12, 8, "bfloat16") == \
        pytest.approx(0.1284 * MS, abs=HALF)


def test_shapes_from_the_cells():
    c = cell("mamba-f32-train-200")
    assert bounds.scan_shapes(c.cfg, c.traffic) == [
        (32, 960_000), (32, 960_000), (8, 3_840_000)]
    c = cell("mamba-f32-eval-512x832")
    assert bounds.scan_shapes(c.cfg, c.traffic) == [
        (32, 10_223_616), (32, 10_223_616), (8, 40_894_464)]
    c = cell("swin-bf16-eval-512x832")
    assert bounds.attention_shapes(c.cfg, c.traffic) == [
        (106_496, 32, 12, 8), (106_496, 32, 12, 8), (425_984, 8, 12, 8)]
    c = cell("mamba-f32-train-200")
    per_step = harness.load_metric("scan_roofline.train").least(
        c.cfg, c.traffic)
    # the forward keeps h for the backward: one more output than eval's
    assert per_step["bwd"] == pytest.approx(1.3480 * MS, abs=2 * HALF)
    assert per_step["fwd"] > 0.6740 * MS
    assert harness.load_metric("scan_roofline.eval").least(
        c.cfg, c.traffic)["fwd"] == pytest.approx(0.6740 * MS, abs=2 * HALF)
    c = cell("swin-bf16-eval-512x832")
    assert harness.load_metric("attn_roofline.eval").least(
        c.cfg, c.traffic)["fwd"] == pytest.approx(3 * 0.0734 * MS * 10.6496,
                                                  rel=0.3)


def test_roofline_counts_steps_by_launches_and_folds_the_dbias_sum():
    """Two steps of the bf16 attention in the window: the bound of two
    steps over the time of the forward, the backward and the dbias sum."""
    c = cell("swin-bf16-train-200")
    kernels = {"attn_fwd_bf16_kernel": (6, 3e-3),
               "attn_bwd_bf16_kernel": (6, 5e-3),
               "dbias_sum_kernel": (6, 2e-3),
               "attn_bwd_kernel": (0, 0.0)}
    ctx = readers.Context(cfg=c.cfg, traffic=c.traffic, workload=c.workload,
                          summary=trace.Summary(1.0, 1.0, kernels),
                          samples=2, peak_bytes=1)
    m = harness.load_metric("attn_roofline.train")
    least = m.least(c.cfg, c.traffic)
    assert m.read(ctx) == pytest.approx(
        100 * 2 * (least["fwd"] + least["bwd"]) / 10e-3)
    assert harness.load_metric("scan_roofline.train").read(ctx) is None


def test_union_counts_overlap_once():
    assert trace.union([(0, 10), (5, 12), (12, 14), (20, 30), (25, 26)]) \
        == [(0, 14), (20, 30)]
    assert trace.clip([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]


class Ev:
    def __init__(self, name, dev, a, b, annotation=False):
        self._n, self._d, self._a, self._b = name, dev, a, b
        self._u = annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def is_user_annotation(self):
        return self._u


def test_summary_of_a_timeline():
    w = trace.WINDOW
    events = [
        Ev(w, "CPU", 100, 1100),
        Ev(w, "CUDA", 90, 1200, annotation=True),  # the span's device copy
        Ev(trace.PREFIX + "metric_read", "CPU", 500, 700),
        Ev("void fused_scan_n1_fwd_kernel(float const*)", "CUDA", 100, 400),
        Ev("void attn_fwd_bf16_kernel<1, 4>(bf16)", "CUDA", 300, 500),
        Ev("gemm", "CUDA", 800, 1000),
        Ev("gemm", "CUDA", 50, 90),  # before the window
        Ev("void at::native::(anonymous namespace)::cat<float>(float*)",
           "CUDA", 900, 950),  # overlaps the gemm
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(600e-9)   # [100, 500) and [800, 1000)
    assert s.kernel_time("fused_scan_n1_fwd_kernel") == (
        1, pytest.approx(300e-9))
    assert s.kernel_time("attn_fwd_bf16_kernel")[0] == 1
    assert s.kernel_time("attn_fwd_kernel")[0] == 0
    assert s.gaps[0] == ("metric_read", pytest.approx(300e-9))
    assert [k for k, _ in s.breakdown()["device_ops"]][0] == \
        "fused_scan_n1_fwd_kernel"
    assert "at::native::anon::cat<float>" in dict(s.breakdown()["device_ops"])


@pytest.mark.parametrize("name", [
    "mamba-f32-train-200", "swin-bf16-train-200", "mamba-f32-eval-512x832",
    "swin-bf16-eval-512x832"])
def test_stored_flop_counts(name):
    c = cell(name)
    assert steps.flops_per_sample(c.cfg, c.traffic) == \
        c.workload["flops_per_sample"]
