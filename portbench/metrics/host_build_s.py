"""Seconds of the program's host build (host clock): the front end's
generation, ``optimize_inplace`` (and ``taylorAD``), and ``compile_evaluator``'s
lowering, tables and upload."""


def read(facts):
    return facts.host_build_s
