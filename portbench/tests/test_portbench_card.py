"""The control of each cell, on the card at the cell's own size: the
program's own lower-precision path (bfloat16 storage, float32 accumulation)
in place of the float32 the configuration states, on three seeds, each a
short window at the cell's own load.  Its numbers must fail the cell's
limits (its readings are printed; run with ``-s`` to see them).  The
benchmark's own runs do not run it."""
import json
import os
import time

import pytest

from portbench import bench

CONTROL_SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)
WINDOW_S = 1.0


def _cells():
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_the_cells_limits(card, cell):
    c = bench.load_cell(cell)
    for seed in CONTROL_SEEDS:
        r = bench.run(c, seed=seed, seconds=WINDOW_S, trace=False, device=card,
                      t_start=time.perf_counter(), dtype="bfloat16", acc_dtype="float32")
        print(f"control {cell} seed {seed}: "
              + ", ".join(f"{k} {v['value']!r} (limit {v['limit']!r})"
                          for k, v in r["checks"].items()), flush=True)
        assert not r["correct"]
