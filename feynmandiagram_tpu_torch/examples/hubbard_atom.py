"""Hubbard-atom self-energy: exact vs diagrammatic MC through the port.

Port of ``examples/hubbard_atom.py``.  The Hubbard atom (single site,
H = U n_up n_down - mu N) has a closed-form self-energy, making it an
end-to-end physics oracle for the whole framework: parquet sigma diagrams ->
lowering -> batched graph evaluation on the card -> Matsubara phase ->
Monte-Carlo tau integration.

Run:  python -m feynmandiagram_tpu_torch.examples.hubbard_atom [--device cpu]
"""
import argparse
import math

from feynmandiagram_tpu_torch.models.hubbard_atom import (exact_sigma, sigma_mc,
                                                          sigma_power_series)

BETA, U = 2.3, 1.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    coeffs = sigma_power_series(BETA)
    print(f"Hubbard atom, beta={BETA}, U={U}, mu=0, at i*omega_0")
    print(f"closed form  Sigma(i w0) = {exact_sigma(math.pi / BETA, U, BETA):.6f}")
    print()
    print(f"{'order':>5} {'MC estimate':>28} {'stderr':>22} {'analytic':>24}")
    for order in (1, 2, 3):
        mean, err = sigma_mc(order, U, BETA, batch=8192, chunks=16, seed=order,
                             device=args.device)
        expect = coeffs[order - 1] * U ** order
        print(f"{order:>5} {mean:>28.6f} {err:>22.6f} {expect:>24.6f}")


if __name__ == "__main__":
    main()
