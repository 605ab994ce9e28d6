"""Rows the kNN seed's covering boxes returned per neighbour answered:
Σ `KnnResult.box_rows` over the traced kNN calls over the neighbours
they returned.  1 is a box that holds the k nearest and nothing more;
above it, the rows the Range path retrieved and the refine ranked in
vain.  A program whose results carry no `box_rows` reads nothing."""

NAME = "knn_box_rows_per_neighbor"
UNIT = "rows/neighbor"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "facade and executor"
MOVES = "qps"
KINDS = ("knn",)


def read(t):
    knn = [r for kind, _, _, r in t.calls_made if kind == "knn"]
    if not knn or any(getattr(r, "box_rows", None) is None for r in knn):
        return None
    neighbours = sum(len(r.neighbors) for r in knn)
    if not neighbours:
        return None
    return sum(int(r.box_rows.sum()) for r in knn) / neighbours
