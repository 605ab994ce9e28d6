"""Host time of the escalation ladder's rungs (`api/exec/executor.py`:
each rung's device call over the still-overflowed windows and its merge,
one `executor.escalate` span a rung), summed over the traced calls, per
window query.  A traced window whose calls ran no rung reads 0; one
without the program's `database.query` spans (each call's root) reads
nothing."""

NAME = "escalation_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "facade and executor"
MOVES = "qps"


def read(t):
    if not any(s.name == "database.query" for s in t.spans):
        return None
    ns = sum(s.dur_ns for s in t.spans if s.name == "executor.escalate")
    return ns / 1e3 / t.queries
