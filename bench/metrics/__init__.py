"""Per-layer readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric.  Each file's ``read(ctx)`` returns
the metric's value from a traced run's context, or None when the run
holds nothing to read (the harness then leaves the metric out).

A serving run's context: ``iterations`` (the batcher's loop iterations
inside the window, from the harness's beats and the clients' stamps:
``ts``, ``dur``, ``steps`` and ``chunks`` run, the ``positions`` decoded
and the prompt lengths of the ``firsts`` tokens produced), ``t0`` /
``t1`` (the window), ``p0`` / ``p1`` and ``profile`` (the profiled
sub-window and its device summary: ``busy_s``, ``window_s``,
``by_name`` seconds per kernel name), ``config`` (the configuration
file), ``serving`` (the cell's serving settings) and ``seconds``.  A
training run's: ``steps`` (each timed step's ``start``, ``end``,
``batch`` and ``seq``), ``t0`` / ``t1``, ``profile`` and ``config``.
``spans.py`` holds the readings several metrics share."""
