"""A frozen copy of the host pieces the reference needs: the graph IR and its
optimizer, Taylor-mode AD and the Parquet front end.  See ../README.md for
where each file came from; the files are kept as they were copied."""
import sys as _sys

# host-side graph generation is recursive over deep DAGs
if _sys.getrecursionlimit() < 100000:
    _sys.setrecursionlimit(100000)
