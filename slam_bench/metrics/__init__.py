"""One reader a metric: ``<metric name>.py`` with ``read(records)``, which
returns the metric's value from a run's records, or None where the run has
nothing to read (the harness then leaves the metric out of the line).
``_arith.py`` holds the operation and byte counts of the kernels and the
device shares that several readers use."""
