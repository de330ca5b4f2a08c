"""One module per measured loop, named by a traffic mix's ``loop``:
``run(call, pool, order, seconds, device, keep, mark) -> window.Window``
drives the entry's ``call`` over the pool's batches in ``order`` for
``seconds``, keeps the last outputs of the pool batches in ``keep``, and
with ``mark`` names its host spans (``window.SPANS``) for the profiler."""
