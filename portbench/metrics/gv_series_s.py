"""Seconds of the program's GV series entry in the run's set-up
(``frontends.gv.diagsGV_series``: the reads of the tables, ``optimize_inplace``
and ``taylorAD`` of every order, and the last ``optimize_inplace``), by its
top-level set-up phase ``diagsGV_series`` (``utils.profiling.phases``, on
``time.perf_counter``).  A program that records no such phase, or a run that
built the series other than once, reads nothing."""


def read(facts):
    from feynmandiagram_tpu_torch.utils import profiling

    phases = getattr(profiling, "phases", None)
    if phases is None:
        return None
    spans = [p.end - p.start for p in phases()
             if p.parent is None and p.name == "diagsGV_series"]
    return spans[0] if len(spans) == 1 else None
