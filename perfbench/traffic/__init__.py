"""Traffic: one general generator (``mix.py``) that reads a cell's
parameters from ``workloads/<cell>.json``, and the length sampler it uses
(``lengths.py``)."""
