"""One module per clip kind, named by a traffic mix's ``clips.kind``:
``lengths(clips, cfg, pool) -> list[list[int]]``, the clip lengths in
samples of every batch of the pool. The lengths never depend on the run's
seed, so that every seed does the same work."""
