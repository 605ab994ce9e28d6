"""Baseline indexes of the paper's comparison, on the host (numpy).

``zm``    — ZM-index: z-order + a learned forward index + fixed paging
            (an `LMSFCIndex` with every LMSFC optimization off).
``rstar`` — STR bulk-loaded packed R-tree (R*-tree query semantics).
``flood`` — Flood: a learned grid over d−1 dims, sorted on the last.
``fnz``   — FindNextZaddress / BIGMIN skipping (``skipping="fnz"``).
"""
