"""Range: the rows inside each closed window, in lexicographic order
(`repro_torch.api.Range` through `Database.query`).  A window's rows are
compared exactly, order included, with the plain reference's."""
import numpy as np

NAME = "range"
CHECK = "wrong_row_sets"      # windows whose rows, or their order, differ


def make_query(Ls, Us):
    from repro_torch.api import Range
    return Range(Ls, Us)


def program(res, n: int) -> list:
    """The program's answers, in the reference's form."""
    return [res.rows_for(i) for i in range(n)]


def reference(ref, Ls, Us) -> list:
    """`ref`'s answers (`ref.window.WindowReference`, or its control)."""
    return ref.rows(Ls, Us)


def wrong(got, want) -> int:
    return sum(not (g.shape == w.shape and np.array_equal(g, w))
               for g, w in zip(got, want))
