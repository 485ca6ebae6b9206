"""Tests of the benchmark harness.  Those marked ``card`` need a CUDA card;
whether there is one is decided inside the ``card`` fixture, never while a
module is imported."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card with "
                    "python -m pytest slam_bench/tests -m card -n 0")
    return torch.device("cuda", 0)


def make_tiny_root(root: Path) -> Path:
    """A benchmark root beside the real one: the real metric readers and
    a small configuration (16 x 360, small caps, loop gate 4 s) with one
    replay and one live mix of a gentle circle, each cell with generous
    limits, so that a CPU run of a few scans goes through every step."""
    import dataclasses
    import json
    import shutil

    from lego_loam_tpu_torch.core import config as C

    src = REPO / "slam_bench"
    d = root / "slam_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    for f in (src / "metrics").glob("*.py"):
        shutil.copy(f, d / "metrics" / f.name)
    cfg = C.LegoLoamConfig(
        laser=C.LaserConfig(num_horizontal_scans=900),
        feature=C.FeatureConfig(max_sharp=128, max_less_sharp=1024,
                                max_flat=256, max_less_flat=4096,
                                odom_surf_iters=15, odom_corner_iters=15),
        mapping=C.MappingConfig(max_map_corner=4096, max_map_surf=8192,
                                max_keyframes=256, scan2map_iters=6,
                                loop_closure_time_gap=4.0,
                                loop_history_cap=8192, loop_source_cap=1024,
                                icp_max_iters=30),
        pipeline=C.PipelineConfig(max_points=14400, max_segmented=8192,
                                  max_outlier=2048))
    with open(d / "configs" / "tiny.json", "w") as f:
        json.dump({"factory": "vlp16", "config": dataclasses.asdict(cfg)}, f)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "slam_bench/configs/tiny.json",
                        "reduced": [], "why": "test"}]
    spec["workloads"] = []
    for mode in ("replay", "live"):
        traffic = {"mode": mode, "noise_m": 0.01, "noised_laps": 2,
                   "world_seed": 21,
                   "setup_laps": 0, "warmup_scans": 6,
                   "trajectory": {"kind": "circle", "radius_m": 6.5,
                                  "scans_per_lap": 314, "height_m": 0.8}}
        with open(d / "traffic" / f"tiny_{mode}.json", "w") as f:
            json.dump(traffic, f)
        work = {"trace": {"first_scan": 2, "scans": 3},
                "stage_check": {"scans": 2, "among": 10},
                "check_scans": 12,
                "limits": {"nonfinite_poses": {"max": 0},
                           "saturation": {"max": 0}, "ate_m": {"max": 1.0},
                           "drift10_median_m": {"max": 0.25},
                           "drift1_p95_m": {"max": 0.5},
                           "k1_label_errors": {"max": 0},
                           "odom_nn_excess_m2": {"max": 1e-3},
                           "k2_knn_excess_m2": {"max": 1e-4}}}
        with open(d / "workloads" / f"tiny.{mode}.json", "w") as f:
            json.dump(work, f)
        spec["workloads"].append({"name": f"tiny.{mode}", "config": "tiny",
                                  "traffic": f"tiny_{mode}", "chips": 1,
                                  "why": "test"})
    real = {w["name"]: ("tiny.live" if "live" in w["name"] else "tiny.replay")
            for w in json.loads((REPO / "BENCHMARK.json").read_text())
            ["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({real[w] for w in m["workloads"]})
    # the live loop's metrics, for the tiny live cell
    have = {m["name"] for m in spec["end_to_end"]}
    for name in ("latency_p50_ms", "latency_p95_ms"):
        if name not in have:
            spec["end_to_end"].append({
                "name": name, "unit": "ms", "better": "lower", "bound": 0.25,
                "source": "host_clock", "workloads": ["tiny.live"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny_bench"))
