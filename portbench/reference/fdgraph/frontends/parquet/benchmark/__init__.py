"""Benchmark oracles: exact diagram-count formulas and (see vertex4_oracle)
an independent legacy-style parquet evaluator used as a test oracle.

Reference: FeynmanDiagram.jl/src/frontend/parquet/benchmark/.
"""
from .diagram_count import (count_ver3_g2v, count_ver3_G2v, count_ver3_G2W,
                            count_sigma_G2v, count_sigma_G2W,
                            count_polar_G2v, count_polar_G2W,
                            count_polar_g2v_noFock_upup,
                            count_polar_g2v_noFock_updown,
                            count_polar_g2v_noFock)
