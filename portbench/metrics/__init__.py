"""One reader a metric: ``metrics/<name>.py`` defines ``read(facts)``, which
returns the metric's value from a run's ``facts`` (``bench.Facts``), or
``None`` where the run holds nothing to read it from; the harness then
leaves the metric out of the line."""
