"""Small cells of the benchmark's configurations, for tests on the CPU."""


def small_cell(config: str, traffic: dict, limits: dict, order: int = 2):
    """A cell of the benchmark's configuration ``config`` cut to ``order``
    (a size a CPU test holds), with ``traffic`` and ``limits``."""
    import json
    import os

    from portbench import bench

    with open(os.path.join(bench.HERE, "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg["innerLoopNum"] = order
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return bench.Cell(name=f"{config}.test", chips=1, config=cfg, traffic=traffic,
                      limits=limits, end_to_end=b["end_to_end"], per_layer=b["per_layer"])


MC_TRAFFIC = {"generator": "mc_captured", "batch": 64, "chunk_passes": 2, "check_chunks": 2,
              "trace_passes": 2}
CALL_TRAFFIC = {"generator": "call_eager", "batch": 64, "pool": 3, "trace_calls": 2}
SEED = 2 ** 31 + 12345
