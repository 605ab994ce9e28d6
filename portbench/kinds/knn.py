"""kNN: the k nearest rows of each centre under squared L2, in ascending
exact distance with the (distance, lexicographic row) tie-break
(`repro_torch.api.Knn` through `Database.query`).

Each window of the mix gives one centre, its midpoint: a mix with
`skew_frac` 0.9 puts 90% of the centres on data rows (within one unit,
the windows' integer rounding; at the domain's edge the clip moves them)
and 10% uniform over the data space.  K_NEAREST and METRIC are the
configuration's (`configs/osm-10m-knn.json` "knn").  A centre's rows, in
order, and each distance are compared exactly with the plain reference
(`ref/knn.py`)."""
import numpy as np

NAME = "knn"
CHECK = "wrong_neighbors"     # centres whose rows, order or distances differ
K_NEAREST = 10
METRIC = "l2"
# the result fields the harness reads of every call; a program whose
# KnnResult lacks them cannot run this kind, and fails at its first call
RESULT_FIELDS = ("overflowed", "residual_overflow", "box_rows")


def centres(Ls, Us) -> np.ndarray:
    """Each window's midpoint, (Q, d) uint64."""
    return (np.asarray(Ls, dtype=np.uint64) + np.asarray(Us, np.uint64)) \
        // np.uint64(2)


def _require_fields() -> None:
    import dataclasses

    from repro_torch.api.result import KnnResult
    missing = set(RESULT_FIELDS) - {f.name for f in
                                    dataclasses.fields(KnnResult)}
    if missing:
        raise RuntimeError(f"KnnResult has no {sorted(missing)}: this "
                           f"program cannot serve the kNN kind")


def make_query(Ls, Us):
    from repro_torch.api import Knn
    _require_fields()
    return Knn(centres(Ls, Us), k=K_NEAREST, metric=METRIC)


def program(res, n: int) -> list:
    """The program's answers, in the reference's form."""
    return [(res.neighbors_for(i), res.dists_for(i)) for i in range(n)]


def reference(ref, Ls, Us) -> list:
    """`ref`'s answers (`ref.window.WindowReference`, or its control)."""
    from portbench.ref.knn import nearest
    return nearest(ref, centres(Ls, Us), K_NEAREST)


def wrong(got, want) -> int:
    return sum(not (g.shape == w.shape and np.array_equal(g, w)
                    and np.array_equal(gd, wd))
               for (g, gd), (w, wd) in zip(got, want))
