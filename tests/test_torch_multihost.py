"""The port's multi-process runtime: 2 worker processes x 2 local CPU
shards join one ``torch.distributed`` process group (``gloo``) and run a
cross-process reduction, the factor-sharded pose-graph solve over the
4-shard global mesh, and a data-parallel replay of one stream a shard whose
outputs are gathered.

Each worker is ``python -m lego_loam_tpu_torch.distributed.multihost`` in a
process of its own, started without this test's pytest or JAX state, with
one intra-op thread (as this process runs torch, so the replays sum alike).
Every wait has a timeout: the workers' own (the process group's, 60 s) and
this test's on each worker; on a timeout the workers are killed and their
stderr is shown.  Tolerances: the solve as in
``tests/test_torch_distributed.py`` (1e-4), the gathered replay 1e-5, the
graph copy against the JAX package's 1e-5 (float32 composes on both
sides)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lego_loam_tpu.distributed import multihost as jmultihost
from lego_loam_tpu_torch.distributed import multihost
from lego_loam_tpu_torch.graph.posegraph import optimize_poses
from lego_loam_tpu_torch.io.npz_io import pack_sequence
from lego_loam_tpu_torch.pipeline.slam import replay
from torch_port_util import tnp, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC, N_LOCAL, N_SCANS = 2, 2, 5
WAIT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_workers(out, n_proc, *extra):
    """Start ``n_proc`` workers, wait for each (killing all on a timeout),
    and return process 0's results."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lego_loam_tpu_torch.distributed.multihost",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n_proc), "--process-id", str(pid),
         "--out", out, "--backend", "gloo", "--device", "cpu",
         "--local-devices", str(N_LOCAL), *extra],
        env=_worker_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(n_proc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WAIT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate() for p in procs]
        pytest.fail("multihost workers timed out:\n" + "\n".join(
            f"--- worker {k} stderr\n{err.decode()[-3000:]}"
            for k, (_, err) in enumerate(logs)))
    for pid, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (
            f"worker {pid} rc={p.returncode}\n--- stdout\n"
            f"{so.decode()[-2000:]}\n--- stderr\n{se.decode()[-4000:]}")
    assert os.path.exists(out), "process 0 wrote no results"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost") / "mh.npz")
    return _run_workers(out, N_PROC, "--n-scans", str(N_SCANS))


def test_cross_process_psum(results):
    n = int(results["n_devices"])
    assert n == N_PROC * N_LOCAL and int(results["n_processes"]) == N_PROC
    assert float(results["psum"]) == n * (n - 1) / 2.0


def test_cross_process_solve_matches_single_device(results):
    poses, n_nodes, g = multihost._pgo_graph("cpu")
    ref, ref_it = optimize_poses(poses, n_nodes, g, gn_iters=6,
                                 pcg_iters=64, return_iters=True)
    np.testing.assert_allclose(results["solved"], tnp(ref), rtol=1e-4,
                               atol=1e-4)
    # every partial sum went through the backend's all_reduce: the psum
    # check's one, then per GN step the gradient, D, the chain sub-diagonal
    # and one H·x a PCG iteration
    it = results["pcg_iterations"].tolist()
    assert int(results["all_reduces"]) == 1 + 3 * len(it) + sum(it)
    assert np.abs(results["solved"] - tnp(poses)).max() > 0.01
    assert len(results["pcg_iterations"]) == 6
    assert max(results["pcg_iterations"]) < 64


def test_pgo_graph_copy_equals_the_jax_original():
    poses, n_nodes, g = multihost._pgo_graph("cpu")
    jposes, jn, jg = to_np(jmultihost._pgo_graph())
    np.testing.assert_allclose(tnp(poses), jposes, rtol=0, atol=1e-5)
    assert int(n_nodes) == int(jn)
    for name in ("i", "j", "valid", "prior", "prior_weight"):
        np.testing.assert_array_equal(tnp(getattr(g, name)),
                                      getattr(jg, name), err_msg=name)
    for name in ("z", "weight"):
        np.testing.assert_allclose(tnp(getattr(g, name)), getattr(jg, name),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_gathered_replay_matches_per_stream_replay(results):
    fused = results["fused"]
    n = N_PROC * N_LOCAL
    assert fused.shape == (n, N_SCANS, 6)
    cfg = multihost.replay_config()
    for stream in range(n):
        scans, _, times = multihost.stream_sequence(stream, N_SCANS)
        x, v, t = pack_sequence(scans, times, cfg, device="cpu")
        ref = tnp(replay(x, v, t, cfg, device="cpu")[1]["fused"])
        np.testing.assert_allclose(fused[stream], ref, rtol=0, atol=1e-5,
                                   err_msg=f"stream {stream}")
    assert np.abs(fused[0] - fused[-1]).max() > 0.01


def test_bench_worker_reports_a_rate(tmp_path):
    """``--bench``: one process, its 2 shards' streams replayed between two
    barriers; the aggregate scans/s of the run."""
    z = _run_workers(str(tmp_path / "bench.npz"), 1, "--bench", "--n-scans",
                     "3")
    assert int(z["n_devices"]) == N_LOCAL and int(z["n_processes"]) == 1
    assert float(z["rate"]) > 0 and float(z["seconds"]) > 0
    assert abs(float(z["rate"]) * float(z["seconds"]) - N_LOCAL * 3) < 1e-6


def test_worker_cli_refuses_a_missing_backend(capsys):
    with pytest.raises(SystemExit):
        multihost.main(["--coordinator", "127.0.0.1:1", "--num-processes",
                        "1", "--process-id", "0", "--out", "x.npz"])
    assert "--backend" in capsys.readouterr().err
