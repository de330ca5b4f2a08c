"""One reader per metric of ``BENCHMARK.json``: ``read(run)`` returns the
value, or None where the run holds nothing to read it from (the harness then
leaves the metric out of the line). A ``--trace 0`` run reads the cell's
end-to-end metrics, a ``--trace 1`` run its per-layer metrics. ``run``
(``run.Run``) carries the measured window (``window``), the traced window
and its trace (``traced``, ``trace``; None without ``--trace 1``), the
launch and table-miss deltas over the measured window (``launches``,
``misses``), the peak of allocated device memory over the measured window
(``peak_bytes``), the set-up's seconds (``setup_s``), the configuration,
the entry's name and ops, and the pool's batch shapes and audio seconds."""
