"""One reader a per-layer metric: ``read(run) -> float | None``, None
when the run holds nothing for it to read."""
