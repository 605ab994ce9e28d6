"""The port's SMBO curve learning (Algorithm 1) against the reference.

The same numpy-seeded toy problem goes through `repro` and `repro_torch`:
the surrogate, the acquisition, the pooled evaluator (the reference's
jitted program against the port's torch program on the CPU), the cost
evaluator and the whole `learn_sfc` loop.  Integer stats, costs, curves and
histories must be equal (tolerance 0; costs to the last ulp).  The one
float32 step, Expected Improvement, has its tolerance stated in its test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batcheval as rb
from repro.core import cost as rcost
from repro.core import smbo as rsmbo
from repro.core import surrogate as rsur
from repro.core import zorder64 as rz
from repro.core.curve import random_curve as r_random_curve
from repro.core.index import IndexConfig as RConfig
from repro.core.index import LMSFCIndex as RIndex
from repro_torch.core import batcheval as tb
from repro_torch.core import cost as tcost
from repro_torch.core import sfc as tsfc
from repro_torch.core import smbo as tsmbo
from repro_torch.core import surrogate as tsur
from repro_torch.core import zorder64 as tz
from repro_torch.core.curve import curve_from_json
from repro_torch.core.index import IndexConfig, LMSFCIndex


def _toy_problem(seed=0, n=1500, n_q=20, d=2, K=10):
    rng = np.random.default_rng(seed)
    data = np.unique(
        rng.integers(0, 2**K, size=(n, d), dtype=np.uint64), axis=0)
    dom = 2**K - 1
    ctr = data[rng.integers(0, len(data), n_q)].astype(np.float64)
    w = rng.integers(1, dom // 4, size=(n_q, d)).astype(np.float64)
    Ls = np.clip(ctr - w / 2, 0, dom).astype(np.uint64)
    Us = np.clip(ctr + w / 2, 0, dom).astype(np.uint64)
    return data, Ls, Us, K


def _cfgs():
    return (RConfig(paging="heuristic", page_bytes=1024),
            IndexConfig(paging="heuristic", page_bytes=1024))


def _curves(specs, d, K):
    """(reference curves, the same curves in the port) from
    (family, depth, seed) triples."""
    ref = [r_random_curve(np.random.default_rng(s), d, K, family=f, depth=dp)
           for f, dp, s in specs]
    return ref, [curve_from_json(c.to_json()) for c in ref]


MIXED = [("global", 1, 0), ("global", 1, 1), ("piecewise", 1, 2),
         ("piecewise", 2, 3), ("piecewise", 1, 4)]


@pytest.mark.parametrize("side", ["left", "right"])
def test_z64_searchsorted_matches_reference(side):
    """Exact, including the reference's +inf (-1, -1) page padding and
    queries at 0, at +inf and on the keys themselves."""
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 2**64 - 1, size=(3, 40), dtype=np.uint64,
                                endpoint=False), axis=1)
    keys[:, -7:] = 2**64 - 1                         # +inf padding
    q = rng.integers(0, 2**64 - 1, size=(3, 30), dtype=np.uint64)
    q[:, :3] = [0, 2**64 - 1, 2**63]
    q[:, 3:13] = keys[:, ::4]
    kz, qz = rz.u64_to_z64(keys), rz.u64_to_z64(q)
    batched = tz.z64_searchsorted(torch.from_numpy(kz), torch.from_numpy(qz),
                                  side=side)
    for b in range(3):
        want = np.asarray(rz.z64_searchsorted(jnp.asarray(kz[b]),
                                              jnp.asarray(qz[b]), side=side))
        np.testing.assert_array_equal(want, np.searchsorted(keys[b], q[b],
                                                            side=side))
        one = tz.z64_searchsorted(torch.from_numpy(kz[b]),
                                  torch.from_numpy(qz[b].reshape(5, 6, 2)),
                                  side=side)
        np.testing.assert_array_equal(one.numpy().ravel(), want)
        np.testing.assert_array_equal(batched[b].numpy(), want)


def test_index_build_with_pooled_keys_is_identical():
    """`LMSFCIndex.build(z=...)` fed the pooled shared-point encode builds
    the same index as the curve's own `encode_np`."""
    data, Ls, Us, K = _toy_problem(seed=2)
    _, curves = _curves(MIXED, 2, K)
    keys = tcost.pool_keys(curves, data, "cpu")
    cfg = _cfgs()[1]
    for c, z in zip(curves, keys):
        np.testing.assert_array_equal(z, c.encode_np(data))
        a = LMSFCIndex.build(data, curve=c, cfg=cfg, workload=(Ls, Us))
        b = LMSFCIndex.build(data, curve=c, cfg=cfg, workload=(Ls, Us), z=z)
        for f in ("xs", "starts", "mbrs", "sort_dims", "page_zmin",
                  "page_zmax"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="z has shape"):
        LMSFCIndex.build(data, curve=curves[0], cfg=cfg, z=keys[0][:-1])


def test_random_forest_matches_reference():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(40, 12))
    y = 3 * X[:, 0] - 2 * X[:, 3] + 0.05 * rng.normal(size=40)
    Xp = rng.uniform(0, 1, size=(48, 12))
    r_rng, t_rng = np.random.default_rng(3), np.random.default_rng(3)
    r = rsur.RandomForest(rng=r_rng).fit(X, y).predict(Xp)
    t = tsur.RandomForest(rng=t_rng).fit(X, y).predict(Xp)
    for a, b in zip(r, t):
        np.testing.assert_array_equal(a, b)
    assert r_rng.integers(0, 2**62) == t_rng.integers(0, 2**62)


def test_ei_matches_reference_in_float32():
    """EI on a surrogate's real predictions.  Both sides run float32, but
    torch's `erf` and `exp` are not XLA's: they differ by up to 2 ulp, and
    EI = (best - mu)·cdf + sigma·pdf cancels where a candidate is far from
    the incumbent, so the stated bound is a few float32 roundings of the
    two terms, 8·eps32·(|best - mu| + sigma).  The selection the loop makes
    from it (seeded permutation, stable sort, top 4) must be the same."""
    data, Ls, Us, K = _toy_problem(seed=4, n=1000, n_q=12)
    cfg = _cfgs()[1]
    _, curves = _curves([("global", 1, s) for s in range(60)], 2, K)
    y = tcost.evaluate_pool(curves[:12], data, Ls, Us, cfg, K, engine="np",
                            device="cpu")
    model = tsur.RandomForest(rng=np.random.default_rng(1))
    model.fit(np.stack([c.features() for c in curves[:12]]), y)
    mu, sigma = model.predict(np.stack([c.features() for c in curves[12:]]))
    eps = np.finfo(np.float32).eps
    for best in (float(y.min()), float(np.median(y)), float(y.min()) - 0.1):
        want = np.asarray(rsmbo._ei_jax(mu, sigma, best), dtype=np.float64)
        got = tsmbo._ei(mu, sigma, best)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, got.astype(np.float32))
        tol = 8 * eps * (np.abs(best - mu) + np.maximum(sigma, 1e-9))
        assert np.all(np.abs(got - want) <= tol)
        for seed in range(8):
            perm = np.random.default_rng(seed).permutation(len(mu))
            top = lambda e: perm[np.argsort(-e[perm], kind="stable")][:4]
            np.testing.assert_array_equal(top(got), top(want))


def test_run_workload_pool_matches_reference():
    """Counts and `QueryStats` of a mixed global/piecewise pool: the
    port's torch program (on the CPU) and numpy loop against the
    reference's jitted program."""
    data, Ls, Us, K = _toy_problem(seed=3)
    ref_curves, curves = _curves(MIXED, 2, K)
    rcfg, cfg = _cfgs()
    ridx = [RIndex.build(data, curve=c, cfg=rcfg, workload=(Ls, Us))
            for c in ref_curves]
    tidx = [LMSFCIndex.build(data, curve=c, cfg=cfg, workload=(Ls, Us))
            for c in curves]
    want = rb.run_workload_pool(ridx, Ls, Us, engine="jax")
    for engine in ("torch", "np"):
        got = tb.run_workload_pool(tidx, Ls, Us, engine=engine, device="cpu")
        for (rc, ra), (tc_, ta) in zip(want, got):
            np.testing.assert_array_equal(tc_, rc)
            assert dataclasses.asdict(ta) == dataclasses.asdict(ra)
    for ix, jx in zip(ridx, tidx):
        rc, ra = rb.run_workload_batched(ix, Ls, Us)
        tc_, ta = tb.run_workload_batched(jx, Ls, Us)
        np.testing.assert_array_equal(tc_, rc)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ra)
    with pytest.raises(ValueError, match="unknown pool engine"):
        tb.run_workload_pool(tidx, Ls, Us, engine="jax", device="cpu")


def test_pooled_round_makes_one_encode_a_split_level(monkeypatch):
    """A pooled round encodes with k + 2 pooled calls: the shared-point
    keys, one a split level (both corner sets), one for both z-range
    corners; `run_workload_pool` makes k + 1 of them.  Costs equal the
    reference's to the last ulp."""
    data, Ls, Us, K = _toy_problem(seed=4)
    ref_curves, curves = _curves(MIXED, 2, K)
    rcfg, cfg = _cfgs()
    calls = []

    def counting(real):
        def encode(x, pool, **kw):
            calls.append(tuple(x.shape))
            return real(x, pool, **kw)
        return encode

    monkeypatch.setattr(tb, "sfc_encode_pool", counting(tb.sfc_encode_pool))
    monkeypatch.setattr(tcost, "sfc_encode_pool",
                        counting(tcost.sfc_encode_pool))
    got = tcost.evaluate_pool(curves, data, Ls, Us, cfg, K, engine="torch",
                              device="cpu")
    k, (Q, d), P = cfg.k_maxsplit, Ls.shape, len(curves)
    assert calls == ([(len(data), d)]
                     + [(P, 2 * Q * 2**lv * d, d) for lv in range(k)]
                     + [(P, 2 * Q * 2**k, d)])
    np.testing.assert_array_equal(got, rcost.evaluate_pool(
        ref_curves, data, Ls, Us, rcfg, K, engine="jax"))
    calls.clear()
    idx = [LMSFCIndex.build(data, curve=c, cfg=cfg, workload=(Ls, Us))
           for c in curves]
    tb.run_workload_pool(idx, Ls, Us, engine="torch", device="cpu")
    assert len(calls) == k + 1


def test_pooled_round_builds_its_lookup_tables_once(monkeypatch):
    """A pooled round builds its curves' lookup tables once and hands the
    same pool, tables included, to the key encode and to every encode of
    the pooled program.  Costs equal the reference's to the last ulp."""
    data, Ls, Us, K = _toy_problem(seed=5)
    ref_curves, curves = _curves(MIXED, 2, K)
    rcfg, cfg = _cfgs()
    builds, pools = [], []
    real_lut = tsfc.lut_tables

    def lut_tables(pos, d, K):
        builds.append(tuple(pos.shape))
        return real_lut(pos, d, K)

    def counting(real):
        def encode(x, pool, **kw):
            pools.append(pool)
            return real(x, pool, **kw)
        return encode

    monkeypatch.setattr(tsfc, "lut_tables", lut_tables)
    monkeypatch.setattr(tb, "sfc_encode_pool", counting(tb.sfc_encode_pool))
    monkeypatch.setattr(tcost, "sfc_encode_pool",
                        counting(tcost.sfc_encode_pool))
    got = tcost.evaluate_pool(curves, data, Ls, Us, cfg, K, engine="torch",
                              device="cpu")
    assert len(builds) == 1
    assert len(pools) == cfg.k_maxsplit + 2
    assert all(p is pools[0] for p in pools) and pools[0].lut is not None
    np.testing.assert_array_equal(got, rcost.evaluate_pool(
        ref_curves, data, Ls, Us, rcfg, K, engine="jax"))


@pytest.mark.parametrize("family,depth", [("global", 1), ("piecewise", 2)])
def test_evaluate_pool_matches_reference_to_last_ulp(family, depth):
    data, Ls, Us, K = _toy_problem(seed=3)
    ref_curves, curves = _curves([(family, depth, i) for i in range(5)],
                                 2, K)
    rcfg, cfg = _cfgs()
    want = rcost.evaluate_pool(ref_curves, data, Ls, Us, rcfg, K,
                               engine="jax")
    np.testing.assert_array_equal(
        rcost.evaluate_pool(ref_curves, data, Ls, Us, rcfg, K, engine="np"),
        want)
    for engine in ("torch", "np", "auto"):
        got = tcost.evaluate_pool(curves, data, Ls, Us, cfg, K,
                                  engine=engine, device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        [tcost.evaluate_curve(c, data, Ls, Us, cfg, K) for c in curves], want)


@pytest.mark.parametrize("family,depth", [("global", 1), ("piecewise", 2)])
def test_learn_sfc_matches_reference(family, depth):
    """Same seed, same `SMBOResult`: best curve, best cost, history and
    every evaluated (curve, cost), with the evaluation on the port's torch
    program (forced, and under `auto`) against the reference's default."""
    data, Ls, Us, K = _toy_problem(seed=5, n=1000, n_q=12)
    rcfg, cfg = _cfgs()
    kw = dict(K=K, space=family, depth=depth, max_iters=2, n_init=4,
              pool_size=6, evals_per_iter=2, seed=11)
    want = rsmbo.learn_sfc(data, Ls, Us, cfg=rcfg, **kw)
    for evaluator in ("pooled-torch", "pooled"):
        got = tsmbo.learn_sfc(data, Ls, Us, cfg=cfg, evaluator=evaluator,
                              device="cpu", **kw)
        assert got.curve_best.to_json() == want.curve_best.to_json()
        assert got.y_best == want.y_best
        assert got.history == want.history
        assert [(c.to_json(), y) for c, y in got.evaluated] == \
               [(c.to_json(), y) for c, y in want.evaluated]
    assert got.theta_best is got.curve_best


def test_ei_selections_differ_only_below_float32_noise(monkeypatch):
    """Where the pool holds fewer candidates above the noise floor than a
    round selects, the rest are ranked by EI values that are float32
    rounding noise of the cancelling terms (the reference even returns
    negative EI there), and torch's and XLA's `erf` can rank them
    differently: in this run's third round the two candidates below the
    floor come out in opposite order, so its fourth pick, and every round
    after it, differ from the reference's.  Every EI still lies within the
    stated bound of the reference's, and the candidates above the floor are
    ranked the same and ahead of the rest."""
    data, Ls, Us, K = _toy_problem(seed=5, n=1000, n_q=12)
    calls = []
    ei_jax = rsmbo._ei_jax

    def spy(mu, sigma, best):
        out = ei_jax(mu, sigma, best)
        calls.append((np.asarray(mu), np.asarray(sigma), best,
                      np.asarray(out, dtype=np.float64)))
        return out

    monkeypatch.setattr(rsmbo, "_ei_jax", spy)
    rsmbo.learn_sfc(data, Ls, Us, cfg=_cfgs()[0], K=K, max_iters=3,
                    n_init=4, pool_size=8, evals_per_iter=4, seed=11)
    eps = np.finfo(np.float32).eps
    for mu, sigma, best, want in calls:
        got = tsmbo._ei(mu, sigma, best)
        tol = 8 * eps * (np.abs(best - mu) + np.maximum(sigma, 1e-9))
        assert np.all(np.abs(got - want) <= tol)
        above = np.flatnonzero(want > tol)
        np.testing.assert_array_equal(
            above[np.argsort(-got[above], kind="stable")],
            above[np.argsort(-want[above], kind="stable")])
        assert np.all(got[above][:, None] > np.delete(got, above)[None])


def test_auto_engine_takes_the_device_for_big_pools_only():
    assert tcost.auto_engine(4, 100, 5000) == "torch"
    assert tcost.auto_engine(3, 1000, 1000) == "np"
    assert tcost.auto_engine(8, 10, 1000) == "np"


def test_learn_sfc_without_a_card_raises(monkeypatch):
    """No device given and no card: the entry points raise instead of
    quietly running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, Ls, Us, K = _toy_problem(seed=1, n=400, n_q=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsmbo.learn_sfc(data, Ls, Us, K=K, max_iters=1, n_init=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcost.evaluate_pool(_curves(MIXED[:1], 2, K)[1], data, Ls, Us, K=K)


def test_learn_sfc_rejects_unknown_evaluators_and_engines():
    data, Ls, Us, K = _toy_problem(seed=1, n=400, n_q=4)
    for name in ("warp-drive", "pooled-jax"):
        with pytest.raises(ValueError, match="unknown evaluator"):
            tsmbo.learn_sfc(data, Ls, Us, K=K, evaluator=name, device="cpu")
    with pytest.raises(ValueError, match="unknown pool engine"):
        tcost.evaluate_pool(_curves(MIXED[:1], 2, K)[1], data, Ls, Us, K=K,
                            engine="jax", device="cpu")
