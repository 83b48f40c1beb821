"""Traffic generators: one module per kind of traffic, named by the
``driver`` key of a file in ``portbench/workloads/``."""
