"""One reader per per-layer metric, named as the metric (its unit, layer
and ``moves`` are its entry in ``BENCHMARK.json``): ``read(ctx)`` (ctx: a
``portbench.cell.Context`` of rank 0's run) returns the value, or None
where the run has nothing for it to read."""
