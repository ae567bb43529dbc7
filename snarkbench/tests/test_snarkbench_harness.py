"""The harness on the CPU: the import check, discovery by file name, the
window's arithmetic, phase attribution, and a whole run of a small cell
on the port's plain CPU path."""

import json
import os
import shutil
import sys
import types

import pytest
import torch

from snarkbench import harness
from snarkbench import phases as ph

torch.set_num_threads(1)
PKG = harness.PKG


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("icicle_snark_tpu_torch", "icicle_snark_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules(list(sys.modules)) == []
    for name in ("icicle_snark_tpu", "jax.numpy", "jaxlib", "flax.linen"):
        assert harness.forbidden_modules([name, "icicle_snark_tpu_torch"]) == [name]
    monkeypatch.setitem(sys.modules, "icicle_snark_tpu", types.ModuleType("icicle_snark_tpu"))
    assert harness.forbidden_modules(list(sys.modules)) == ["icicle_snark_tpu"]


def test_nothing_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import icicle_snark_tpu\n",
                            "from icicle_snark_tpu ", "from icicle_snark_tpu.",
                            "import icicle_snark_tpu."):
                    assert bad not in text, (f, bad)


def test_benchmark_cells_resolve_to_their_files():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for cell in bench["workloads"]:
        _, config, traffic, e2e, layer = harness.resolve(cell["name"])
        assert config["name"] == cell["config"]
        assert harness.traffic_driver(traffic["kind"]).drive
        for spec in e2e + layer:
            assert callable(harness.metric_reader(spec["name"]))


def _data_dir(tmp_path):
    """A copy of the benchmark's data files with one more configuration,
    traffic mix, metric and kernel, added as files only."""
    d = tmp_path / "data"
    for sub in ("configs", "traffic", "metrics", "kernels"):
        shutil.copytree(os.path.join(PKG, sub), d / sub)
    (d / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "builder": "snarkbench.circuits.complex", "setup_seed": "tiny",
        "params": {"num_variables": 20, "num_constraints": 20, "witnesses_per_seed": 2}}))
    traffic = json.loads((d / "traffic" / "closed-warm.json").read_text())
    traffic.update(warmup_proves=1, traced_proves=1)
    (d / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    (d / "traffic" / "tiny-cold.json").write_text(json.dumps(dict(traffic, cache="cold")))
    (d / "kernels" / "new_pass.json").write_text(json.dumps({"functions": ["fused_kernel"]}))
    (d / "metrics" / "proofs_total.py").write_text(
        "def read(run):\n    return len(run.window_requests)\n")
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    bench["workloads"] += [{"name": "tiny.warm", "config": "tiny", "traffic": "tiny-mix",
                            "chips": 1, "why": "a test cell"},
                           {"name": "tiny.cold", "config": "tiny", "traffic": "tiny-cold",
                            "chips": 1, "why": "a test cell, a new cache each request"}]
    for m in bench["end_to_end"]:
        if m["name"] in ("proofs_per_s", "prove_ms_p90"):
            m["workloads"] += ["tiny.warm", "tiny.cold"]
    bench["end_to_end"].append({"name": "proofs_total", "unit": "proofs", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.warm"]})
    return str(d), bench


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    data, bench = _data_dir(tmp_path)
    cell, config, traffic, e2e, _ = harness.resolve("tiny.warm", bench, data)
    assert config["params"]["num_variables"] == 20 and traffic["warmup_proves"] == 1
    assert [m["name"] for m in e2e][-1] == "proofs_total"
    _, _, _, e2e_other, _ = harness.resolve("complex-1600k.warm", bench, data)
    assert "proofs_total" not in [m["name"] for m in e2e_other]
    # a kernel whose CUDA functions do not hold its name: one file more
    assert harness.kernel_functions("new_pass", data) == ["fused_kernel"]
    assert harness.kernel_functions("field_vec", data) == ["field_vec_kernel"]
    assert harness.kernel_functions("no_file") == ["no_file"]
    assert "r1cs_fold_kernel" in harness.kernel_functions("r1cs_rows")


def test_per_layer_metrics_follow_the_metric_they_move():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for cell in bench["workloads"]:
        _, _, _, e2e, layer = harness.resolve(cell["name"])
        reported = {m["name"] for m in e2e}
        assert "setup_s" in reported and len(reported) >= 2 and layer
        for m in layer:
            assert m["moves"] in reported, (cell["name"], m["name"])
    names = [m["name"] for m in harness.resolve("anon_aadhaar-1536.warm")[4]]
    assert "proofs_per_s.hostbound" in names and "msm.ms" not in names
    names = [m["name"] for m in harness.resolve("complex-1600k.warm")[4]]
    assert "msm.ms" in names and "msm.ms.hostbound" not in names
    assert "cache.load_ms" in names


def test_hostbound_readers_read_as_their_originals():
    reqs = _window([0.1, 0.2, 0.3])
    for r in reqs:
        r["phases"] = {"witness_ingest": 0.01, "r1cs_ntt": 0.002, "msm": 0.05,
                       "randomize_assemble": 0.01, "serialize": 0.001}
    run = types.SimpleNamespace(window_requests=reqs, data=PKG,
                                window_s=reqs[-1]["t1"] - reqs[0]["t0"])
    for name in ("proofs_per_s", "prove_ms_p90", "ingest.ms", "api.ms", "msm.ms"):
        assert harness.metric_reader(f"{name}.hostbound")(run) == \
            harness.metric_reader(name)(run), name


def test_device_time_per_proof_over_the_window():
    run = types.SimpleNamespace(window_requests=_window([0.1] * 10, fail={4}),
                                window_busy_s=0.45)
    assert harness.metric_reader("device_ms_per_proof")(run) == pytest.approx(50.0)
    run.window_busy_s = None  # the trace left out a kernel, or no card
    assert harness.metric_reader("device_ms_per_proof")(run) is None


def _window(latencies, gap=0.001, fail=()):
    t, reqs = 100.0, []
    for i, lat in enumerate(latencies):
        reqs.append({"i": i, "w": 0, "t0": t, "t1": t + lat, "latency": lat,
                     "error": "boom" if i in fail else None})
        t += lat + gap
    return reqs


def test_rate_and_p90_over_every_request():
    run = types.SimpleNamespace()
    lat = [0.1] * 90 + [0.2] * 9 + [1.0]
    run.window_requests = _window(lat)
    run.window_s = run.window_requests[-1]["t1"] - run.window_requests[0]["t0"]
    rate = harness.metric_reader("proofs_per_s")(run)
    assert rate == pytest.approx(100 / (sum(lat) + 99 * 0.001))
    assert harness.metric_reader("prove_ms_p90")(run) == pytest.approx(100.0)
    run.window_requests = _window([0.1] * 89 + [0.2] * 11)
    assert harness.metric_reader("prove_ms_p90")(run) == pytest.approx(200.0)
    run.window_requests = _window([0.1] * 100, fail={3})
    assert harness.metric_reader("proofs_per_s")(run) == pytest.approx(99 / run.window_s)
    assert harness.percentile([5, 1, 3, 2, 4], 90) == 5
    assert harness.percentile([5, 1, 3, 2, 4], 50) == 3


def test_phase_attribution_of_synthetic_events():
    phases = [("witness_ingest", 0.0, 1.0), ("r1cs_ntt", 1.0, 2.0), ("msm", 2.0, 5.0),
              ("randomize_assemble", 5.0, 6.0)]
    device = [("memcpy", 0.5, 0.9), ("void ntt_block_kernel<1>(int)", 1.1, 1.5),
              ("k2", 1.4, 1.6), ("void msm_accumulate_kernel<E1, true>(int)", 2.0, 3.0),
              ("sort", 2.5, 3.5), ("late", 5.8, 6.5)]
    got = ph.attribute(phases, device)
    assert got["busy"] == pytest.approx({"witness_ingest": 0.4, "r1cs_ntt": 0.5, "msm": 1.5,
                                         "randomize_assemble": 0.2})
    assert got["busy_total"] == pytest.approx(2.6) and got["span"] == 6.0
    assert got["ops"]["late"] == pytest.approx(0.2)
    gaps = sorted(got["gaps"], key=lambda g: -g[1])
    assert gaps[0] == ("msm", pytest.approx(1.5))
    assert sum(g for _, g in got["gaps"]) == pytest.approx(6.0 - 2.6)
    assert ph.kernel_name("void msm_accumulate_kernel<E1, true>(int, long)") == \
        "msm_accumulate_kernel<E1, true>"
    assert ph.merge([(3, 4), (1, 2), (1.5, 3.5)]) == [(1, 4)]


def test_idle_and_roofline_readers_on_synthetic_traces():
    run = types.SimpleNamespace(
        profiled=[{"span": 2.0, "busy_total": 0.5, "busy": {"msm": 0.4}, "req": {"w": 0}},
                  {"span": 2.0, "busy_total": 1.5, "busy": {"msm": 0.2}, "req": {"w": 0}}],
        work={0: {"msm_muls": 0.01 * 64 * 132 * 1.98e9, "msm_bytes": 0}})
    assert harness.metric_reader("device.idle_pct")(run) == pytest.approx(50.0)
    # bound 10 ms over 400 and 200 ms: 2.5 % and 5 %, median 3.75 %
    assert harness.metric_reader("msm_roofline")(run) == pytest.approx(3.75)
    run.profiled = []
    assert harness.metric_reader("msm_roofline")(run) is None
    assert harness.metric_reader("device.idle_pct")(run) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    data, bench = _data_dir(d)
    return data, bench, str(d / "fixtures")


def cpu_run(tiny, seed=2**40 + 7, trace=False, seconds=0.5, cell="tiny.warm"):
    data, bench, fx = tiny
    run = harness.Run(cell, seed, seconds, trace, device="cpu", bench=bench, data=data,
                      fixture_root=fx, log=lambda msg: None)
    run.profile = lambda: None  # the profiled stretch is the card's
    return harness.execute(run)


def test_a_whole_run_on_the_cpu_is_correct(tiny):
    res = cpu_run(tiny)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"proofs_per_s", "prove_ms_p90", "setup_s", "proofs_total"}
    assert res["checks"] == {"wrong": {"value": 0, "limit": 0},
                             "repeated": {"value": 0, "limit": 0}}
    traced = cpu_run(tiny, trace=True)
    assert traced["correct"] and "msm.ms" in traced["metrics"] and "breakdown" in traced


def test_the_cold_mix_loads_the_cache_for_every_request(tiny, monkeypatch):
    from icicle_snark_tpu_torch.prover import cache

    loads = []
    real = cache.load_zkey_cache
    monkeypatch.setattr(cache, "load_zkey_cache", lambda *a, **k: loads.append(1) or real(*a, **k))
    res = cpu_run(tiny, cell="tiny.cold")
    assert res["correct"]
    # one load in set-up (warm-up proves reuse it), one in each window request
    assert len(loads) == 1 + res["attempted"] - 1


def test_phase_readers_take_medians_over_the_window():
    reqs = _window([0.100, 0.200, 0.300])
    for r, k in zip(reqs, (1, 2, 3)):
        r["phases"] = {"witness_ingest": 0.01 * k, "r1cs_ntt": 0.002, "msm": 0.05 * k,
                       "randomize_assemble": 0.01, "serialize": 0.001 * k}
    run = types.SimpleNamespace(window_requests=reqs)
    read = harness.metric_reader
    assert read("ingest.ms")(run) == pytest.approx(20.0)
    assert read("msm.ms")(run) == pytest.approx(100.0)
    assert read("assemble.ms")(run) == pytest.approx(12.0)
    # 0.2 - (0.02 + 0.002 + 0.1 + 0.01 + 0.002)
    assert read("api.ms")(run) == pytest.approx(66.0)
    run.window_requests = _window([0.1])
    assert read("ingest.ms")(run) is None
