"""The fused R-FAST wave commit (``grid.commit_grid``), its plain
version, the per-node oracle (``ref``) and the launch counters
(``dispatch``)."""
