"""Seconds from the harness's start to the window's: the program's host
build, its kernels' build on a checkout's first run, the warm-up and
capture of the cell's own shapes."""


def read(facts):
    return facts.setup_s
