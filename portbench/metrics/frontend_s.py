"""Seconds of the program's host front end in the run's set-up, by the
program's own set-up phases (``utils.profiling.phases``, on
``time.perf_counter``): the sum of the top-level front-end entries
(``vertex4``, ``sigma``, ``diagsGV``, ``diagsGV_ver4``), ``optimize_inplace``
and ``taylorAD``.  A program that records no phases, or a run that
compiled other than once (``compile_evaluator``), reads nothing."""

FRONT_END = ("vertex4", "sigma", "diagsGV", "diagsGV_ver4", "optimize_inplace", "taylorAD")


def read(facts):
    from feynmandiagram_tpu_torch.utils import profiling

    phases = getattr(profiling, "phases", None)
    if phases is None:
        return None
    top = [p for p in phases() if p.parent is None]
    if sum(p.name == "compile_evaluator" for p in top) != 1:
        return None
    spans = [p.end - p.start for p in top if p.name in FRONT_END]
    return sum(spans) if spans else None
