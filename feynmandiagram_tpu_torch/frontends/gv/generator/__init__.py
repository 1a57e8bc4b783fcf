"""Offline diagram-table generator (the L0 component).

Host copy of ``feynmandiagram_tpu/frontends/gv/generator``, unchanged: it
writes the same bytes.  That package re-implements FeynmanDiagram.jl's
Python-2 generator pipeline (src/frontend/GV_diagrams/*.py, algorithm of
Nat Commun 10, 3725 (2019)) in Python 3:

1. ``hugenholtz``: enumerate connected vacuum (lnZ) Hugenholtz diagrams as
   slot permutations, grouped into unlabeled classes by the deformation
   group (direct<->exchange x half-swap x interaction relabeling) with
   symmetry factors sign/|Aut| — replacing the reference's pre-committed
   ``Diagram/HugenDiag*.diag`` seed files.
2. ``attach``: attach external vertices to lnZ diagrams -> polarization /
   self-energy / Green-function topologies with integer loop bases.
3. ``tables``: serialize to the ``.diag`` text contract consumed by
   ``frontends.gv.readfile`` (including counterterm-order files).

Validation strategy (the JAX package's tests/test_generator.py; the port's
text is held to the JAX package's and to the bundled tables by
tests/test_torch_generator.py): leaf==1 evaluation per external-tau
group is loop-basis independent and must match the reference tables; exact
momentum routing is validated by exhaustive Z_p-lattice momentum sums, which
are invariant under any GL(n, Z) change of loop basis.
"""
from .hugenholtz import lnz_classes, fermi_sign, is_connected, find_loops
from .attach import attach_external_vertices, group_polar
from .tables import (generate_polar, generate_sigma, generate_green,
                     generate_free_energy, generate_tables, write_table)
