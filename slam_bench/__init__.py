"""The benchmark of ``lego_loam_tpu_torch`` (see ``slam_bench/run.py``)."""
