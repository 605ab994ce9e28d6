"""Count: the rows inside each closed window, one count a window
(`repro_torch.api.Count` through `Database.query`).  Compared exactly
with the plain reference's count."""
import numpy as np

NAME = "count"
CHECK = "wrong_counts"        # windows whose count differs


def make_query(Ls, Us):
    from repro_torch.api import Count
    return Count(Ls, Us)


def program(res, n: int) -> np.ndarray:
    """The program's answers, in the reference's form."""
    return np.asarray(res.counts)


def reference(ref, Ls, Us) -> np.ndarray:
    """`ref`'s answers (`ref.window.WindowReference`, or its control)."""
    return ref.count(Ls, Us)


def wrong(got, want) -> int:
    return int(np.count_nonzero(np.asarray(got) != np.asarray(want)))
