"""Each metric's reader on a synthetic record, and the byte models of the
two roofline metrics against PERF.md's numbers."""

import pytest

from perfbench import cells, devtrace, peaks

MG512 = {"levels": [[512 >> i] * 3 for i in range(8)], "pre": 1, "post": 1,
         "pre_dtype": "bfloat16", "dtype": "float32"}


def record(order=2, trace=True, grid=(512, 512, 512), mg=MG512):
    table = {
        "void sweep_kernel<float, float>(...)": [16, 0.0140],
        "void colour_kernel<__nv_bfloat16>(...)": [0, 0.0],
        "void restrict_kernel<float, __nv_bfloat16>(...)": [7, 0.0051],
        "void prolong_add_kernel<float>(...)": [7, 0.0053],
        "sm90_xmma_gemm_f32f32_tn": [28, 0.0196],
        "void compact_reg_kernel<float, 16>(...)": [12, 0.0120],
        "void stencil7_kernel<float>(...)": [7, 0.0034],
        "void regular_fft_factor<512, float>(...)": [4, 0.0060],
        "void vector_fft_r2c<float>(...)": [2, 0.0020],
        "Memcpy DtoH (Device -> Pinned)": [7, 0.00001],
    }
    rec = {"cell": "x", "grid": list(grid), "order": order, "itemsize": 4,
           "setup_s": 12.5, "setup": {"build_s": 0.25}, "mg": mg,
           "window": {"wall_s": 20.0, "solves": 250, "solve_ms": [70.0] * 240 + [90.0] * 10},
           "iterations": [7, 7]}
    if trace:
        rec["trace"] = dict(devtrace.summarise(table), wall_s=0.5, untraced_wall_s=0.4,
                            table=table)
        rec["window"] = {"wall_s": 0.5, "solves": 2, "solve_ms": [250.0, 250.0]}
    return rec


def read(name, rec):
    return cells.reader(name)(rec)


def test_byte_models_give_perf_md_numbers():
    lap = cells.metric_module("compact_roofline").laplacian_bytes
    assert peaks.floor_s(lap([512] * 3, 4)) * 1e3 == pytest.approx(0.3205, abs=5e-5)
    assert peaks.floor_s(512**3 * 4) * 1e3 == pytest.approx(0.160, abs=5e-4)
    cyc = cells.metric_module("smoother_roofline").cycle_bytes
    fine = 512**3
    # fine level: the bf16 pre-smooth from zero (b read, u written) and
    # the f32 post-smooth (u, b read, u written); each coarser level 1/8
    assert cyc(MG512) == sum((fine >> (3 * i)) * (2 * 2 + 3 * 4) for i in range(7))


def test_end_to_end_readers():
    one = record(trace=False)
    assert read("setup_s", one) == 12.5
    assert read("solve_ms", one) == pytest.approx(80.0)
    assert read("solve_ms", record()) is None
    assert read("solve_ms.host", one) == read("solve_ms", one)
    # 250 solves: the 95th percentile by nearest rank is the 238th
    assert read("solve_ms_p95", one) == 70.0
    one["window"]["solve_ms"] = [70.0] * 237 + [90.0] * 13
    assert read("solve_ms_p95", one) == 90.0
    assert read("solve_ms_p95.host", one) == 90.0
    assert read("solve_ms_p95", record()) is None


def test_per_layer_readers():
    rec = record()
    assert read("build_s", rec) == 0.25
    assert read("iterations", rec) == 7
    kernels = 16 + 7 + 7 + 28 + 12 + 7 + 4 + 2
    assert read("launches_per_it", rec) == pytest.approx(kernels / 14)
    assert read("mg_device_ms", rec) == pytest.approx(1e3 * (0.0140 + 0.0051 + 0.0053 + 0.0196) / 2)
    dev = 0.0140 + 0.0051 + 0.0053 + 0.0196 + 0.0120 + 0.0034 + 0.0060 + 0.0020 + 0.00001
    assert read("busy_pct", rec) == pytest.approx(100 * dev / 0.4)
    cyc = cells.metric_module("smoother_roofline").cycle_bytes(MG512)
    assert read("smoother_roofline", rec) == pytest.approx(100 * 14 * cyc / peaks.HBM_BPS / 0.0140)
    assert read("compact_roofline", rec) is None and read("fft_device_ms", rec) is None
    for name in ("iterations", "launches_per_it", "busy_pct"):
        assert read(name + ".host", rec) == read(name, rec)


def test_per_layer_readers_of_a_direct_solve():
    rec = record(order=6, mg=None)
    rec["iterations"] = [1, 1]
    assert read("compact_roofline", rec) == pytest.approx(
        100 * 2 * 2 * 512**3 * 4 / peaks.HBM_BPS / 0.0120)
    assert read("fft_device_ms", rec) == pytest.approx(1e3 * 0.0080 / 2)
    assert read("mg_device_ms", rec) is None and read("smoother_roofline", rec) is None


def test_a_reader_with_nothing_to_read_is_left_out():
    rec = record()
    for row in rec["trace"]["table"].values():
        row[1] = 0.0
    rec["trace"].update(devtrace.summarise(rec["trace"]["table"]))
    man = cells.manifest()
    got = cells.read_metrics(cells.metrics_for("poisson7.512.f32", man, True), rec)
    assert "smoother_roofline" not in got and "busy_pct" not in got
    assert set(got) <= {m["name"] for m in man["per_layer"]}


def test_devtrace_summary_and_top_ops():
    table = record()["trace"]["table"]
    s = devtrace.summarise(table)
    assert s["launches"] == 16 + 7 + 7 + 28 + 12 + 7 + 4 + 2
    assert s["device_s"] == pytest.approx(sum(v[1] for v in table.values()))
    top = devtrace.top_ops(table, 3)
    assert [r[0] for r in top][0].startswith("sm90") and len(top) == 3
