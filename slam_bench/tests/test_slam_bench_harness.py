"""The harness: every name in ``BENCHMARK.json`` found by its files, the
contract's character and structure rules, a CPU run of each traffic loop at
a tiny size, the faults the check must catch, and the result line."""

import dataclasses
import json
import re
import shutil
import time

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch.core import config as C
from slam_bench import run as bench_run
from slam_bench.harness import REPO, Bench, build_config, run_cell

CPU = torch.device("cpu")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_loads_from_its_files():
    bench = Bench()
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        spec = bench.config(cell["config"])
        cfg = build_config(spec)
        # the files hold the configurations as the port ships them
        assert cfg == getattr(C, spec["factory"])()
        traffic = bench.traffic(cell["traffic"])
        assert traffic["mode"] in ("replay", "live")
        work = bench.workload(w["name"])
        assert work["limits"] and work["trace"]["scans"] > 0
        for traced in (False, True):
            for m in bench.metrics_for(w["name"], traced):
                assert callable(bench.reader(m["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_benchmark_json_keeps_the_contract_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["slam_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slam_bench/") and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    reported = {}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", cells):
            reported.setdefault(cell, set()).add(m["name"])
    assert all("setup_s" in r and len(r) >= 2 for r in reported.values())
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        # exactly the cells that report the end-to-end metric it moves
        assert sorted(m["workloads"]) == sorted(
            c for c in cells if m["moves"] in reported[c])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_a_new_cell_mix_and_metric_come_from_new_files_alone(tmp_path):
    src = REPO / "slam_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(src / sub, tmp_path / "slam_bench" / sub)
    spec = json.loads(json.dumps(SPEC))
    d = tmp_path / "slam_bench"
    traffic = json.loads((d / "traffic" / "replay_lap_r6.5m.json").read_text())
    traffic["trajectory"]["radius_m"] = 9.0
    (d / "traffic" / "replay_lap_r9m.json").write_text(json.dumps(traffic))
    (d / "workloads" / "vlp16.replay.r9m.json").write_text(
        (d / "workloads" / "vlp16.replay.laps.json").read_text())
    (d / "metrics" / "keyframe_gap.py").write_text(
        "def read(records):\n    return records.get('keyframe_gap')\n")
    spec["workloads"].append({"name": "vlp16.replay.r9m", "config": "vlp16",
                              "traffic": "replay_lap_r9m", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "scans_per_s":
            m["workloads"].append("vlp16.replay.r9m")
    spec["per_layer"].append({
        "name": "keyframe_gap", "unit": "m", "better": "lower",
        "source": "program_counter", "layer": "stage 3 with loop closure",
        "moves": "scans_per_s", "workloads": ["vlp16.replay.r9m"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(tmp_path)
    cell = bench.cell("vlp16.replay.r9m")
    assert bench.traffic(cell["traffic"])["trajectory"]["radius_m"] == 9.0
    assert build_config(bench.config(cell["config"])) == C.vlp16()
    e2e = [m["name"] for m in bench.metrics_for("vlp16.replay.r9m", False)]
    assert e2e == ["scans_per_s", "setup_s"]
    layer = [m["name"] for m in bench.metrics_for("vlp16.replay.r9m", True)]
    assert layer == ["keyframe_gap"]
    assert bench.reader("keyframe_gap")({"keyframe_gap": 0.3}) == 0.3
    # the cells already there see nothing new
    assert "keyframe_gap" not in [
        m["name"] for m in bench.metrics_for("vlp16.replay.laps", True)]


def _run(root, cell, traced, seconds):
    return run_cell(Bench(root), cell, 2 ** 31 + 12345, seconds, traced, CPU,
                    time.perf_counter())


@pytest.fixture(scope="module")
def tiny_runs(tiny_root):
    torch.manual_seed(0)
    # a traced run profiles every host op of its slice, which on the CPU
    # takes seconds: it gets a longer window to serve as many scans
    return {(cell, traced): _run(tiny_root, cell, traced, 5.0 if traced else 4.0)
            for cell in ("tiny.replay", "tiny.live") for traced in (0, 1)}


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.live"])
def test_cpu_run_of_each_mix(tiny_runs, cell):
    res = tiny_runs[(cell, 0)]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    want = {"tiny.replay": {"scans_per_s", "setup_s"},
            "tiny.live": {"latency_p50_ms", "latency_p95_ms", "setup_s"}}
    assert set(res["metrics"]) == want[cell]
    assert all(v["value"] > 0 for v in res["metrics"].values())
    traced = tiny_runs[(cell, 1)]
    assert traced["correct"]
    # the CPU has no stage events and no device trace: those readers find
    # nothing and their metrics are left out
    assert "profile" in traced["records"]
    assert traced["records"]["profile"]["scans"] == 3


def test_the_result_line(tiny_runs):
    for traced in (0, 1):
        res = tiny_runs[("tiny.replay", traced)]
        cell = {"chips": 1}
        earlier, line, checks = bench_run.compose(
            res, cell, "NVIDIA H100 80GB HBM3", bool(traced), 7, "tiny.replay")
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        if traced:
            keys.append("breakdown")
        assert list(line) == keys + ["checks"]
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert ("busy_s" in dev and "window_s" in dev) == bool(traced)
        if traced:
            for k in ("device_ops", "idle_gaps"):
                assert len(line["breakdown"][k]) <= 10
        assert set(line["checks"]) == {c["name"] for c in res["checks"]}
        assert all(set(c) == {"value", "limit", "op"}
                   for c in line["checks"].values())
        assert len(checks) == len(res["checks"])
        json.dumps(line, allow_nan=False)
        json.dumps(earlier, allow_nan=False)


FAULTS = {
    # fault: the number that has to fail it
    "state_unchanged": "drift10_median_m",
    "answer_altered": "drift10_median_m",
    "mapping_pose": "drift1_p95_m",
    "labels_altered": "k1_label_errors",
    "pick_moved": "odom_nn_excess_m2",
    "knn_altered": "k2_knn_excess_m2",
}


def _plant(monkeypatch, fault):
    """Break the timed path underneath the harness, where the answer is
    produced."""
    from lego_loam_tpu_torch.frontend import segmentation
    from lego_loam_tpu_torch.match import cuda_knn
    from lego_loam_tpu_torch.pipeline import slam
    from lego_loam_tpu_torch.solve import odometry
    step = slam.slam_step

    def broken_step(state, raw, cfg, device=None, mesh=None):
        new, out = step(state, raw, cfg, device=device, mesh=mesh)
        if fault == "state_unchanged":
            return state, out
        if fault == "answer_altered":
            # the served pose with x and y swapped
            return new, {**out, "fused": out["fused"][[0, 1, 2, 4, 3, 5]]}
        # a mapping cycle's served pose 1 m off, one scan in five
        if state.scan_index % 5 == 4:
            out = {**out, "fused": out["fused"]
                   + torch.tensor([0, 0, 0, 1.0, 0, 0])}
        return new, out

    if fault in ("state_unchanged", "answer_altered", "mapping_pose"):
        monkeypatch.setattr(slam, "slam_step", broken_step)
    elif fault == "labels_altered":
        label = segmentation.propagate_labels

        def one_label_off(labels0, right, down, *a, **k):
            out = label(labels0, right, down, *a, **k).clone()
            seg = (out != 2 ** 30).reshape(-1).nonzero()
            out.view(-1)[seg[len(seg) // 2]] += 1
            return out
        monkeypatch.setattr(segmentation, "propagate_labels", one_label_off)
    elif fault == "pick_moved":
        search = odometry._search_surf

        def moved(theta, query, last, cfg):
            corr = search(theta, query, last, cfg)
            return dataclasses.replace(corr, a=corr.a + 0.05)
        monkeypatch.setattr(odometry, "_search_surf", moved)
    else:
        plain = cuda_knn.knn5_torch

        def fifth_wrong(query, query_valid, cand, cand_valid):
            idx, d2 = plain(query, query_valid, cand, cand_valid)
            idx = idx.clone()
            idx[:, 4] = (idx[:, 4] + 1) % cand.shape[0]
            return idx, d2
        monkeypatch.setattr(cuda_knn, "knn5_torch", fifth_wrong)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    """The run as the harness drives it, with the timed path broken
    underneath: the check must read ``correct`` false, by the number that
    judges that part of the path."""
    _plant(monkeypatch, fault)
    for cell in ("tiny.replay", "tiny.live"):
        res = _run(tiny_root, cell, False, 4.0)
        failed = {c["name"] for c in res["checks"] if not c["ok"]}
        assert not res["correct"], (cell, res["values"])
        assert FAULTS[fault] in failed, (cell, failed, res["values"])


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "vlp16.replay.laps", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_reference_numbers_on_a_known_trajectory():
    from slam_bench.gen.world import Circle
    from slam_bench.reference import truth
    c = Circle(radius=6.5, scans_per_lap=314, period=0.1)
    n = 40
    t_next = (np.arange(n) + 1) * 0.1
    true = c.pose_at(t_next)
    fused = true.copy()
    fused[:, 3:] -= c.pose_at(0.0)[3:]
    out = {"fused": fused, "i": np.array([0, 1, 5]),
           "j": np.array([1, 2, 0]), "z": np.zeros((3, 6)),
           "kf_stamp": np.arange(6) * 0.5, "kf_dropped": 0,
           "factor_dropped": 0, "map_sat": 0}
    vals = truth.numbers(out, c.pose_at, 0.1, 0)
    assert vals["ate_m"] < 1e-9 and vals["drift10_median_m"] < 1e-9
    assert vals["drift50_median_m"] == float("inf")    # 40 scans: none
    assert vals["loop_factors"] == 1
    # the one loop factor measured zero motion where the truth moved
    gap = np.linalg.norm(c.pose_at(0.1)[3:] - c.pose_at(2.6)[3:])
    assert abs(vals["loop_gap_max_m"] - gap) < 1e-9
    ok, rows = truth.judge(vals, {"ate_m": {"max": 0.1},
                                  "loop_factors": {"min": 2}})
    assert not ok and [r["ok"] for r in rows] == [True, False]
