"""Run one cell of the benchmark of ``feynmandiagram_tpu_torch`` once and
print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card (exit 2
without one).  See portbench/README.md.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this folder, is where imports start: the folder's
# own modules must not stand in for top-level ones
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

import argparse  # noqa: E402

# caches of any kernel compiler, at fixed places inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".portbench_cache", _sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from portbench import bench
    return bench.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
