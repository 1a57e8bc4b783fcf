"""Strong-coupling (hopping) expansion worked example on the ED Atom oracle.

Port of ``examples/strong_coupling_expansion.py``.  Around the atomic
limit, the lattice Green's function expands in the hopping t with ATOMIC
correlation functions as building blocks.  For the Hubbard dimer, the
leading off-diagonal term is one hopping line joining two exact atomic
propagators:

    G_01(iw_n) = t * g_atom(iw_n)^2 + O(t^3)

(odd in t, so the next correction is t^3).  The script checks this against
the full dimer ED at several t and prints the convergence table, with the
connected 4-point ``g2_connected`` that supplies the higher-order vertices.
The Green's functions run in float64 on the card (``models.atom_ed``).

Run:  python -m feynmandiagram_tpu_torch.examples.strong_coupling_expansion
          [U] [mu] [beta] [--device cpu]
"""
import argparse

from feynmandiagram_tpu_torch.models.atom_ed import hubbard_atom_model, hubbard_dimer_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("u", nargs="?", type=float, default=2.0)
    parser.add_argument("mu", nargs="?", type=float, default=0.3)
    parser.add_argument("beta", nargs="?", type=float, default=1.2)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    u, mu, beta, device = args.u, args.mu, args.beta, args.device

    atom = hubbard_atom_model(u, mu, beta)
    g_at = atom.g_matsubara(3, device=device)
    print(f"# Hubbard dimer vs 1st-order hopping expansion "
          f"(U={u}, mu={mu}, beta={beta})")
    print(f"{'t':>6} {'n':>2} {'|G01_ED - t*g^2|':>18} {'.. / t^3':>10}")
    for t in (0.02, 0.05, 0.1, 0.2):
        dimer = hubbard_dimer_model(t, u, mu, beta)
        g01 = dimer.g_matsubara(3, 0, 1, device=device)   # site0-up <- site1-up
        for n in range(3):
            err = abs(g01[n] - t * g_at[n] ** 2)
            print(f"{t:>6} {n:>2} {err:>18.3e} {err / t**3:>10.4f}")

    # the atomic connected vertex (the O(t^2) SCE ingredient)
    gc = atom.g2_connected(0.8 * beta, 0.35 * beta, 0.6 * beta, 0.1 * beta,
                           0, 1, 1, 0, device=device)
    print(f"# atomic connected 4-point at sample times: {gc:.6f} "
          "(vanishes at U=0; feeds the O(t^2) SCE diagrams)")


if __name__ == "__main__":
    main()
