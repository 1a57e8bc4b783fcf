"""Seconds of ``compile_evaluator`` in the run's set-up (the lowering, the
leaf tables and the upload), by the program's own set-up phase
(``utils.profiling.phases``, on ``time.perf_counter``).  A program that
records no phases, or a run that compiled other than once, reads
nothing."""


def read(facts):
    from feynmandiagram_tpu_torch.utils import profiling

    phases = getattr(profiling, "phases", None)
    if phases is None:
        return None
    spans = [p.end - p.start for p in phases()
             if p.parent is None and p.name == "compile_evaluator"]
    return spans[0] if len(spans) == 1 else None
