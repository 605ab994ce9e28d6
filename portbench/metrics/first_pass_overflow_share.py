"""Share of the traced windows whose first pass overflowed the candidate
pages (`max_cand`) or the row-id buffer (`max_hits`), from the results'
own first-pass flags: each such window is served again (escalation) or
by the CPU net, so its first pass was wasted work."""

import numpy as np

NAME = "first_pass_overflow_share"
UNIT = "ratio"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "facade and executor"
MOVES = "qps"


def read(t):
    if not t.calls_made:
        return None
    over = sum(int(np.count_nonzero(r.overflowed))
               for _, _, _, r in t.calls_made)
    return over / t.queries
