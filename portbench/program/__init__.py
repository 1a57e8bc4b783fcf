"""The program's side of each diagram series: ``program/<series>.py`` builds
the series' roots with the port's own front end, as a user of the port
does, and returns ``(roots, n_loop, n_tau)``.  The harness compiles them
with ``compile_evaluator``."""
