"""What three of the program's stages were handed and returned, on the scans
of the window the harness marks, for the stage reference
(``slam_bench/reference/stages.py``) to judge once the window has closed.

The wrappers sit on module attributes that the program's callers look up at
call time: ``frontend/segmentation.py::propagate_labels`` (stage 1, K1 on the
card), ``solve/odometry.py::_search_surf`` and ``_search_corner`` (stage 2's
nearest-neighbour search), and ``match/cuda_knn.py::knn5_cuda_grouped`` with
the CPU's ``knn5_torch`` (stage 3, K2).  On an unmarked scan a wrapper does
one attribute test; on a marked one it keeps device copies of its tensors,
with no host read.
"""

from __future__ import annotations

from typing import Dict, List


class StageRecorder:
    """A context: while entered, the wrappers are in place; ``mark(on)``
    before each scan says whether that scan is kept.  ``knn_launches``:
    how many of K2's launches a marked scan keeps (its first ones)."""

    def __init__(self, knn_launches: int = 2):
        self.on = False
        self.knn_launches = knn_launches
        self._knn_left = 0
        self.records: Dict[str, List] = {"labels": [], "odom": [], "knn": [],
                                         "scans": 0}

    def mark(self, on: bool) -> None:
        self.on = on
        self._knn_left = self.knn_launches
        if on:
            self.records["scans"] += 1

    def __enter__(self):
        from lego_loam_tpu_torch.frontend import segmentation
        from lego_loam_tpu_torch.match import cuda_knn
        from lego_loam_tpu_torch.solve import odometry

        keep = self

        def copy(t):
            return t.detach().clone()

        label = segmentation.propagate_labels

        def propagate_labels(labels0, right, down, *args, **kwargs):
            out = label(labels0, right, down, *args, **kwargs)
            if keep.on:
                if labels0.dim() == 2:
                    keep.records["labels"].append(
                        (copy(labels0), copy(right), copy(down), copy(out)))
                else:
                    for b in range(labels0.shape[0]):
                        keep.records["labels"].append(
                            (copy(labels0[b]), copy(right[b]), copy(down[b]),
                             copy(out[b])))
            return out

        def searching(search):
            def wrapped(theta, query, last, cfg):
                corr = search(theta, query, last, cfg)
                if keep.on:
                    keep.records["odom"].append((
                        copy(theta), copy(query.xyz), copy(query.rel_time),
                        copy(query.valid), copy(last.xyz), copy(last.valid),
                        copy(corr.a),
                        float(cfg.feature.nearest_feature_search_dist) ** 2))
                return corr
            return wrapped

        grouped, plain = cuda_knn.knn5_cuda_grouped, cuda_knn.knn5_torch

        def keep_knn(problem, idx):
            q, qv, c, cv = problem
            keep.records["knn"].append(
                (copy(q), copy(qv), copy(c), copy(cv), copy(idx)))

        def knn5_cuda_grouped(problems):
            results = grouped(problems)
            if keep.on and keep._knn_left > 0:
                keep._knn_left -= 1
                for p, (idx, _) in zip(problems, results):
                    keep_knn(p, idx)
            return results

        def knn5_torch(query, query_valid, cand, cand_valid):
            idx, d2 = plain(query, query_valid, cand, cand_valid)
            if keep.on and keep._knn_left > 0:
                keep._knn_left -= 1
                keep_knn((query, query_valid, cand, cand_valid), idx)
            return idx, d2

        self._undo = [
            (segmentation, "propagate_labels", label),
            (odometry, "_search_surf", odometry._search_surf),
            (odometry, "_search_corner", odometry._search_corner),
            (cuda_knn, "knn5_cuda_grouped", grouped),
            (cuda_knn, "knn5_torch", plain)]
        segmentation.propagate_labels = propagate_labels
        odometry._search_surf = searching(odometry._search_surf)
        odometry._search_corner = searching(odometry._search_corner)
        cuda_knn.knn5_cuda_grouped = knn5_cuda_grouped
        cuda_knn.knn5_torch = knn5_torch
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self.on = False
        return False
