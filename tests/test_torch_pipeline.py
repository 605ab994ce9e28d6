"""The port's training data pipeline (`repro_torch.data.pipeline`) against
the reference's (`repro.data.pipeline`).

Twins of `tests/test_train_substrate.py::test_indexed_pipeline_selection_and_resume`
and `tests/test_store.py::test_indexed_dataset_select_verified_against_mask`,
plus the store-backed (`database=`) case.  The same seeded corpus goes
through both packages: the corpus itself (tokens and metadata), every
selected doc id, every `TokenBatcher` batch and state (a resumed stream
included) must be equal (tolerance 0).  The port's `IndexedDataset` runs
with ``device="cpu"``, so a select is a Range on the `cpu` engine; on a
card it is a Range on the `cuda` engine (the `window_match` kernel),
driven by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest

from repro import api as rapi
from repro.data import pipeline as rpipe
from repro_torch import api as tapi
from repro_torch.data import pipeline as tpipe

WINDOWS = [((0.0, 0.0, 0.7, 0.0), (1.0, 1.0, 1.0, 1.0)),
           ((0.2, 0.0, 0.5, 0.0), (0.9, 1.0, 1.0, 0.8)),
           ((0.0, 0.25, 0.0, 0.1), (0.5, 0.5, 0.9, 0.6)),
           ((0.99, 0.99, 0.99, 0.99), (1.0, 1.0, 1.0, 1.0))]


def _corpus(n_docs, vocab, max_len, seed=0):
    rdocs, rmeta = rpipe.synth_corpus(n_docs, vocab=vocab, max_len=max_len,
                                      seed=seed)
    tdocs, tmeta = tpipe.synth_corpus(n_docs, vocab=vocab, max_len=max_len,
                                      seed=seed)
    np.testing.assert_array_equal(tmeta, rmeta)
    assert len(tdocs) == len(rdocs)
    for a, b in zip(tdocs, rdocs):
        np.testing.assert_array_equal(a, b)
    return tdocs, tmeta


def test_indexed_pipeline_selection_and_resume():
    docs, meta = _corpus(400, 128, 64)
    ds = tpipe.IndexedDataset(docs, meta, seed=0, device="cpu")
    rds = rpipe.IndexedDataset(docs, meta, seed=0)
    assert ds.K == rds.K and ds.db.default_engine == "cpu"
    np.testing.assert_array_equal(ds.meta_int, rds.meta_int)
    np.testing.assert_array_equal(ds.index.starts, rds.index.starts)
    ids = ds.select((0.0, 0.0, 0.7, 0.0), (1.0, 1.0, 1.0, 1.0))
    assert len(ids) > 0
    assert np.all(meta[ids, 2] >= 0.7 - 1e-3)
    for lo, hi in WINDOWS:
        np.testing.assert_array_equal(ds.select(lo, hi), rds.select(lo, hi))

    def phases(mod):
        return [mod.CurriculumPhase("easy", (0.0, 0.0, 0.5, 0.0),
                                    (0.6, 1.0, 1.0, 1.0), steps=3),
                mod.CurriculumPhase("hard", (0.0, 0.0, 0.0, 0.0),
                                    (1.0, 1.0, 1.0, 1.0), steps=2)]
    tb = tpipe.TokenBatcher(ds, phases(tpipe), batch=4, seq_len=32, seed=1)
    batches = list(tb)
    rbatches = list(rpipe.TokenBatcher(rds, phases(rpipe), batch=4,
                                       seq_len=32, seed=1))
    assert len(batches) == len(rbatches) == 5
    assert batches[0][0]["tokens"].shape == (4, 32)
    for (b, st), (rb, rst) in zip(batches, rbatches):
        np.testing.assert_array_equal(b["tokens"], rb["tokens"])
        assert st == rst

    # resume from the recorded state mid-stream
    tb2 = tpipe.TokenBatcher(ds, phases(tpipe), batch=4, seq_len=32, seed=1)
    tb2.set_state(batches[2][1])
    rest = list(tb2)
    assert len(rest) == 2
    rtb2 = rpipe.TokenBatcher(rds, phases(rpipe), batch=4, seq_len=32,
                              seed=1)
    rtb2.set_state(rbatches[2][1])
    for (b, st), (rb, rst) in zip(rest, list(rtb2)):
        np.testing.assert_array_equal(b["tokens"], rb["tokens"])
        assert st == rst


def test_indexed_dataset_select_verified_against_mask():
    docs, meta = _corpus(400, 64, 128)
    ds = tpipe.IndexedDataset(docs, meta, seed=0, verify_selects=True,
                              device="cpu")
    ids = ds.select((0.2, 0.0, 0.5, 0.0), (0.9, 1.0, 1.0, 0.8))
    assert len(ids) > 0 and np.all(np.diff(ids) > 0)
    empty = ds.select((0.99, 0.99, 0.99, 0.99), (1.0, 1.0, 1.0, 1.0))
    assert isinstance(empty, np.ndarray)
    rds = rpipe.IndexedDataset(docs, meta, seed=0, verify_selects=True)
    np.testing.assert_array_equal(
        ids, rds.select((0.2, 0.0, 0.5, 0.0), (0.9, 1.0, 1.0, 0.8)))
    np.testing.assert_array_equal(
        empty, rds.select((0.99, 0.99, 0.99, 0.99), (1.0, 1.0, 1.0, 1.0)))


def test_verify_selects_raises_on_a_wrong_index_answer(monkeypatch):
    """`verify_selects` is a real guard: an index path that drops a row
    raises `RuntimeError` (in both packages)."""
    docs, meta = _corpus(300, 64, 64, seed=2)
    for mod, api in ((tpipe, tapi), (rpipe, rapi)):
        kw = dict(device="cpu") if mod is tpipe else {}
        ds = mod.IndexedDataset(docs, meta, seed=0, verify_selects=True,
                                **kw)
        real = ds.db.query

        def drop_one(q, _real=real):
            res = _real(q)
            if len(res.rows):
                res.rows = res.rows[1:]
            return res
        monkeypatch.setattr(ds.db, "query", drop_one)
        with pytest.raises(RuntimeError, match="mismatch"):
            ds.select((0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0))


@pytest.mark.parametrize("seed", [0, 3])
def test_selected_ids_equal_reference_on_seeded_windows(seed):
    docs, meta = _corpus(1500, 256, 96, seed=seed)
    ds = tpipe.IndexedDataset(docs, meta, seed=seed, verify_selects=True,
                              device="cpu")
    rds = rpipe.IndexedDataset(docs, meta, seed=seed)
    rng = np.random.default_rng(seed + 11)
    for _ in range(12):
        a, b = rng.uniform(0, 1, (2, 4))
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        np.testing.assert_array_equal(ds.select(lo, hi), rds.select(lo, hi))


def test_learned_curve_equals_reference():
    """`learn_curve=True` runs the port's SMBO with the reference's knobs
    (`evals_per_iter=2`: the host loop): the same curve, so the same
    index and the same selections."""
    from repro_torch.data.workload import make_workload
    docs, meta = _corpus(600, 64, 64, seed=4)
    mi = np.floor(meta * (2**16 - 1)).astype(np.uint64)
    wl = make_workload(mi, 20, seed=5, width_scale=0.2, K=16)
    ds = tpipe.IndexedDataset(docs, meta, seed=0, learn_curve=True,
                              workload=wl, device="cpu")
    rds = rpipe.IndexedDataset(docs, meta, seed=0, learn_curve=True,
                               workload=wl)
    assert ds.index.curve.to_json() == rds.index.curve.to_json()
    np.testing.assert_array_equal(ds.index.starts, rds.index.starts)
    lo, hi = (0.1, 0.0, 0.3, 0.2), (0.8, 1.0, 1.0, 0.9)
    np.testing.assert_array_equal(ds.select(lo, hi), rds.select(lo, hi))


def test_store_backed_dataset_selects_through_a_segment(tmp_path):
    """``database=``: the corpus's unique metadata rows as an on-disk
    segment, opened with `Database.from_segment`; selections through its
    `cpu` engine and through the `store` engine (plain twins on the CPU)
    equal the in-memory dataset's and the reference's over the same
    segment."""
    from repro_torch.store import write_segment_from_index
    docs, meta = _corpus(800, 64, 64, seed=6)
    mem = tpipe.IndexedDataset(docs, meta, seed=0, device="cpu")
    path = write_segment_from_index(mem.index, str(tmp_path / "seg"))
    seg = tapi.Database.from_segment(path, device="cpu")
    ds = tpipe.IndexedDataset(docs, meta, seed=0, database=seg,
                              verify_selects=True)
    assert ds.db is seg and ds.index is seg.index
    rds = rpipe.IndexedDataset(docs, meta, seed=0,
                               database=rapi.Database.from_segment(path),
                               verify_selects=True)
    rng = np.random.default_rng(8)
    windows = WINDOWS + [tuple(np.sort(rng.uniform(0, 1, (2, 4)), axis=0))
                         for _ in range(4)]
    for engine in ("cpu", "store"):
        if engine == "store":
            seg.engine("store", tapi.EngineConfig(q_chunk=8, group_pages=8))
            assert seg.engines["store"].backend == "torch"
        for lo, hi in windows:
            got = ds.select(lo, hi)
            np.testing.assert_array_equal(got, mem.select(lo, hi))
            np.testing.assert_array_equal(got, rds.select(lo, hi))


def test_dataset_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``device=`` the dataset's Database serves on the card: with
    no card a select raises instead of serving from the host."""
    import torch
    docs, meta = _corpus(200, 64, 64, seed=9)
    ds = tpipe.IndexedDataset(docs, meta, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.select((0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0))
