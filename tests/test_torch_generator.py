"""The port's GV table generator (``frontends.gv.generator``) against the
JAX package's and against the bundled tables.

For every table that the generator's CLI writes at total order
``o + v + g <= 4`` (Σ, charge and spin polarization, Green's function, free
energy), Vertex4 at orders 1-3 and Vertex4I at order 3, the port's
``generate_*`` must return the same text as the JAX package's (both
``None`` where the CLI writes no file), and that text must equal the
bundled file's bytes.  Tolerance: none, the tables are text.  Total order
5 and Vertex4 at order 4 take minutes (``FreeEnergy5_0_0`` alone more than
100 s) and carry the ``slow`` marker; the bundled set holds only some of
the order-5 files, and a case compares with the bundled file where there
is one.  The JAX package's own ``tests/test_generator.py`` needs the
upstream tables, which this repository does not hold, so this file is
where the generator is checked.
"""
import importlib
import os

import pytest

from test_torch_host import PORT, REF

TABLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "feynmandiagram_tpu", "frontends", "gv", "tables")
# (kind, group directory, file prefix), in the order of the CLI's loop
KINDS = [("sigma", "groups_sigma", "Sigma"), ("charge", "groups_charge", "Polar"),
         ("spin", "groups_spin", "Polar"), ("green", "groups_green", "Green"),
         ("free_energy", "groups_free_energy", "FreeEnergy")]


def cli_cases(total):
    """The (kind, o, v, g) of the CLI's loop at ``--max-total-order total``."""
    cases = []
    for o in range(1, total + 1):
        for v in range(total):
            for g in range(total):
                if o + v + g > total:
                    continue
                cases += [(kind, o, v, g) for kind, _, _ in KINDS
                          if kind != "green" or o + 1 + v + g <= total]
    return cases


def generated(pkg, kind, o, v, g):
    tables = importlib.import_module(f"{pkg}.frontends.gv.generator.tables")
    if kind == "sigma":
        return tables.generate_sigma(o, v, g)
    if kind in ("charge", "spin"):
        return tables.generate_polar(o, v, g, is_spin_polar=kind == "spin")
    if kind == "green":
        return tables.generate_green(o, v, g)
    if kind == "free_energy":
        return tables.generate_free_energy(o, v, g)
    return tables.generate_vertex4(o, fully_irreducible=kind == "vertex4I")


def bundled(kind, o, v, g):
    if kind in ("vertex4", "vertex4I"):
        path = os.path.join(TABLES, "groups_vertex4",
                            f"{'Vertex4I' if kind == 'vertex4I' else 'Vertex4'}{o}_0_0.diag")
    else:
        sub, prefix = next((s, p) for k, s, p in KINDS if k == kind)
        path = os.path.join(TABLES, sub, f"{prefix}{o}_{v}_{g}.diag")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def check(kind, o, v, g, *, bundled_must_exist):
    port, ref = generated(PORT, kind, o, v, g), generated(REF, kind, o, v, g)
    assert port == ref
    on_disk = bundled(kind, o, v, g)
    if port is None:
        assert on_disk is None or not bundled_must_exist
    elif on_disk is not None or bundled_must_exist:
        assert port == on_disk


SMALL = cli_cases(4)
VERTEX4 = [("vertex4", o, 0, 0) for o in (1, 2, 3)] + [("vertex4I", 3, 0, 0)]


def test_case_lists_match_the_cli():
    """The lists above are the CLI's loop: 20 (o, v, g) of total <= 4 for
    each kind but Green's function, 10 for it; 82 of the 94 texts are
    written (not None)."""
    assert len(SMALL) == 4 * 20 + 10 and len(VERTEX4) == 4
    written = [c for c in SMALL + VERTEX4 if bundled(*c) is not None]
    assert len(written) == 82


@pytest.mark.parametrize("kind,o,v,g", SMALL + VERTEX4)
def test_generator_text_matches_jax_and_bundled(kind, o, v, g):
    check(kind, o, v, g, bundled_must_exist=True)


@pytest.mark.slow
@pytest.mark.parametrize("kind,o,v,g", [c for c in cli_cases(5) if c not in SMALL]
                         + [("vertex4", 4, 0, 0)])
def test_generator_text_matches_jax_order5(kind, o, v, g):
    check(kind, o, v, g, bundled_must_exist=False)


def test_cli_writes_the_bundled_bytes(tmp_path):
    """``python -m ...generator`` of the port, at total order 2 and Vertex4
    order 1, writes byte for byte the bundled files of those names, into
    the directory it is given."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-m", f"{PORT}.frontends.gv.generator", str(tmp_path),
                    "--max-total-order", "2", "--vertex4-max", "1", "--vertex4i", ""],
                   check=True, env=env, timeout=300, capture_output=True)
    written = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                     for d, _, files in os.walk(tmp_path) for f in files)
    assert len(written) >= 10
    for rel in written:
        with open(tmp_path / rel, "rb") as a, open(os.path.join(TABLES, rel), "rb") as b:
            assert a.read() == b.read(), rel
