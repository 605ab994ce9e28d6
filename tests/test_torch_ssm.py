"""The port's recurrent blocks against the reference's: Mamba2 (zamba2's
backbone, `repro_torch.models.mamba2`) and xLSTM's mLSTM and sLSTM
(`repro_torch.models.xlstm`), on the reduced zamba2-1.2b and xlstm-125m
configs.

Weights come from the reference's inits cast to float32; inputs are drawn
with numpy from a seed and handed to both packages.

Tolerances:
- float32 modules against the reference's: atol = rtol = 1e-5
  (`mamba2_decode_step`, `mlstm_decode_step`, `mlstm_reference`, the
  sLSTM step and block, the mLSTM block and its decode step), the two
  chunked scans `mamba2_forward` and `mlstm_chunked` included, over
  several chunk sizes (their summation order shows below that bar);
- the port's chunked scans against its own stepwise recurrences: the
  reference's own bar for that comparison, atol 2e-4 / rtol 2e-3
  (tests/test_models_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.models import mamba2 as rm
from repro.models import xlstm as rx
from repro_torch.configs import registry as treg
from repro_torch.models import mamba2 as tm
from repro_torch.models import xlstm as tx

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=2e-4, rtol=2e-3)


def _cfgs(name):
    return (rreg.reduced_config(rreg.get_arch(name)),
            treg.reduced_config(treg.get_arch(name)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _f32_params(p):
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return (jax.tree.map(jnp.asarray, p),
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _states_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k,
                                   **tol)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _mamba(seed=4):
    rcfg, tcfg = _cfgs("zamba2-1.2b")
    rp, _ = rm.init_mamba2(jax.random.PRNGKey(seed), rcfg, RULES)
    jp, tp = _f32_params(rp)
    return rcfg, tcfg, jp, tp


def test_init_mamba2_shapes_and_dtypes_match_reference():
    rcfg, tcfg = _cfgs("zamba2-1.2b")
    rp, _ = rm.init_mamba2(jax.random.PRNGKey(0), rcfg, RULES)
    tp = tm.init_mamba2(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tp.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in rp.items()}
    for k in ("A_log", "dt_bias", "D_skip", "norm_w"):   # not drawn
        np.testing.assert_allclose(_np(tp[k]), _np(rp[k]), **F32_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mamba2_forward_matches_reference(chunk):
    rcfg, tcfg, jp, tp = _mamba()
    x = _f32(np.random.default_rng(chunk), 2, 64, tcfg.d_model, scale=0.5)
    want = rm.mamba2_forward(jp, rcfg, jnp.asarray(x), chunk=chunk)
    got = tm.mamba2_forward(tp, tcfg, torch.from_numpy(x), chunk=chunk)
    assert got.shape == (2, 64, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_mamba2_forward_keeps_the_chunk_assert():
    _, tcfg, _, tp = _mamba()
    x = torch.zeros(1, 48, tcfg.d_model)
    with pytest.raises(AssertionError):
        tm.mamba2_forward(tp, tcfg, x, chunk=32)


def test_mamba2_decode_steps_match_reference():
    """Eight float32 steps from the zero state (conv state bf16, as the
    reference keeps it): outputs and the carried states at 1e-5."""
    rcfg, tcfg, jp, tp = _mamba()
    rng = np.random.default_rng(9)
    B = 2
    rs = rm.mamba2_init_state(rcfg, B)
    ts = tm.mamba2_init_state(tcfg, B, "cpu")
    _states_close(ts, rs, **F32_TOL)
    assert ts["conv"].dtype == torch.bfloat16
    for _ in range(8):
        x = _f32(rng, B, 1, tcfg.d_model, scale=0.5)
        want, rs = rm.mamba2_decode_step(jp, rcfg, jnp.asarray(x), rs)
        got, ts = tm.mamba2_decode_step(tp, tcfg, torch.from_numpy(x), ts)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        _states_close(ts, rs, **F32_TOL)


def test_mamba2_chunked_matches_its_stepwise_decode():
    """The port alone, as the reference's own test: the chunked prefill
    against the stepwise recurrence from the zero state, float32."""
    _, tcfg, _, tp = _mamba()
    x = torch.from_numpy(_f32(np.random.default_rng(5), 2, 32,
                              tcfg.d_model, scale=0.5))
    par = tm.mamba2_forward(tp, tcfg, x, chunk=8)
    st = tm.mamba2_init_state(tcfg, 2, "cpu")
    st["conv"] = st["conv"].float()
    outs = []
    for t in range(32):
        y, st = tm.mamba2_decode_step(tp, tcfg, x[:, t:t + 1], st)
        outs.append(y)
    np.testing.assert_allclose(_np(par), _np(torch.cat(outs, 1)), **SCAN_TOL)


def test_mamba2_masks_before_exp():
    """Large decays: a where after exp would give inf * 0 = nan in the
    masked half; masking first keeps every output finite."""
    _, tcfg, _, tp = _mamba()
    tp = dict(tp, A_log=torch.full_like(tp["A_log"], 6.0))
    x = torch.from_numpy(_f32(np.random.default_rng(6), 1, 64,
                              tcfg.d_model, scale=3.0))
    assert torch.isfinite(tm.mamba2_forward(tp, tcfg, x, chunk=64)).all()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_inputs(seed, B=2, S=64, H=4, dh=32):
    rng = np.random.default_rng(seed)
    q, k, v = (_f32(rng, B, S, H, dh) for _ in range(3))
    i_pre = _f32(rng, B, S, H)
    f_pre = _f32(rng, B, S, H)
    logf = np.asarray(-jax.nn.softplus(-jnp.asarray(f_pre)))
    return q, k, v, i_pre, logf


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mlstm_chunked_matches_reference(chunk):
    ins = _mlstm_inputs(chunk)
    want = rx.mlstm_chunked(*map(jnp.asarray, ins), chunk=chunk)
    got = tx.mlstm_chunked(*(torch.from_numpy(a.copy()) for a in ins),
                           chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    oracle = tx.mlstm_reference(*(torch.from_numpy(a.copy()) for a in ins))
    np.testing.assert_allclose(_np(got), _np(oracle), **SCAN_TOL)


def test_mlstm_reference_and_decode_step_match_reference():
    ins = _mlstm_inputs(11, S=24)
    want = rx.mlstm_reference(*map(jnp.asarray, ins))
    got = tx.mlstm_reference(*(torch.from_numpy(a.copy()) for a in ins))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # one step from a non-trivial state
    q, k, v, i_pre, logf = (a[:, 0] for a in _mlstm_inputs(12, S=1))
    rng = np.random.default_rng(13)
    C = _f32(rng, 2, 4, 32, 33)
    m = _f32(rng, 2, 4)
    rs, rh = rx.mlstm_decode_step({"C": jnp.asarray(C), "m": jnp.asarray(m)},
                                  *map(jnp.asarray, (q, k, v, i_pre, logf)))
    ts, th = tx.mlstm_decode_step(
        {"C": torch.from_numpy(C), "m": torch.from_numpy(m)},
        *(torch.from_numpy(a.copy()) for a in (q, k, v, i_pre, logf)))
    np.testing.assert_allclose(_np(th), _np(rh), **F32_TOL)
    _states_close(ts, rs, **F32_TOL)


def _xlstm_block(kind, seed=3):
    rcfg, tcfg = _cfgs("xlstm-125m")
    init = rx.init_slstm_block if kind == "s" else rx.init_mlstm_block
    rp, _ = init(jax.random.PRNGKey(seed), rcfg, RULES)
    jp, tp = _f32_params(rp)
    return rcfg, tcfg, jp, tp


@pytest.mark.parametrize("kind", ["m", "s"])
def test_xlstm_block_inits_match_reference_shapes(kind):
    rcfg, tcfg = _cfgs("xlstm-125m")
    rinit = rx.init_slstm_block if kind == "s" else rx.init_mlstm_block
    tinit = tx.init_slstm_block if kind == "s" else tx.init_mlstm_block
    rp, _ = rinit(jax.random.PRNGKey(0), rcfg, RULES)
    tp = tinit(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in rp.items()}
    assert all(v.dtype == torch.bfloat16 for v in tp.values())


@pytest.mark.parametrize("chunk", [16, 64])
def test_mlstm_block_matches_reference(chunk):
    rcfg, tcfg, jp, tp = _xlstm_block("m")
    x = _f32(np.random.default_rng(14), 2, 64, tcfg.d_model, scale=0.5)
    want = rx.mlstm_block(jp, rcfg, jnp.asarray(x), chunk=chunk)
    got = tx.mlstm_block(tp, tcfg, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_mlstm_block_decode_steps_match_reference():
    rcfg, tcfg, jp, tp = _xlstm_block("m")
    rng = np.random.default_rng(15)
    rs = rx.mlstm_block_init_state(rcfg, 2)
    ts = tx.mlstm_block_init_state(tcfg, 2, "cpu")
    _states_close(ts, rs, **F32_TOL)
    for _ in range(6):
        x = _f32(rng, 2, 1, tcfg.d_model, scale=0.5)
        want, rs = rx.mlstm_block_decode(jp, rcfg, jnp.asarray(x), rs)
        got, ts = tx.mlstm_block_decode(tp, tcfg, torch.from_numpy(x), ts)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        _states_close(ts, rs, **F32_TOL)


def test_slstm_step_and_block_match_reference():
    rcfg, tcfg, jp, tp = _xlstm_block("s")
    rng = np.random.default_rng(16)
    x = _f32(rng, 2, 24, tcfg.d_model, scale=0.5)
    np.testing.assert_allclose(
        _np(tx.slstm_block(tp, tcfg, torch.from_numpy(x))),
        _np(rx.slstm_block(jp, rcfg, jnp.asarray(x))), **F32_TOL)
    rs = rx.slstm_init_state(rcfg, 2)
    ts = tx.slstm_init_state(tcfg, 2, "cpu")
    _states_close(ts, rs, **F32_TOL)
    for t in range(4):
        gx = _f32(rng, 2, 4 * tcfg.d_model)
        rs, rh = rx.slstm_step(jp, rcfg, jnp.asarray(gx), rs)
        ts, th = tx.slstm_step(tp, tcfg, torch.from_numpy(gx), ts)
        np.testing.assert_allclose(_np(th), _np(rh), **F32_TOL)
        _states_close(ts, rs, **F32_TOL)
    want, _ = rx.slstm_block_decode(jp, rcfg, jnp.asarray(x[:, :1]), rs)
    got, _ = tx.slstm_block_decode(tp, tcfg, torch.from_numpy(x[:, :1]), ts)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_slstm_recurrence_rounds_h_to_bf16_like_reference():
    """bf16 recurrent weights, as the model holds them: h is rounded to
    bf16 before the recurrent product in both packages."""
    rcfg, tcfg = _cfgs("xlstm-125m")
    rp, _ = rx.init_slstm_block(jax.random.PRNGKey(7), rcfg, RULES)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in rp.items()}
    rng = np.random.default_rng(17)
    rs = dict(rx.slstm_init_state(rcfg, 2), h=jnp.asarray(_f32(rng, 2, 4, 32)))
    ts = tx.slstm_init_state(tcfg, 2, "cpu")
    ts["h"] = torch.from_numpy(np.array(rs["h"]))
    gx = _f32(rng, 2, 4 * tcfg.d_model)
    _, rh = rx.slstm_step(rp, rcfg, jnp.asarray(gx), rs)
    _, th = tx.slstm_step(tp, tcfg, torch.from_numpy(gx), ts)
    np.testing.assert_allclose(_np(th), _np(rh), atol=1e-3, rtol=1e-3)


def test_xlstm_reduced_config_is_what_the_tests_assume():
    _, tcfg = _cfgs("xlstm-125m")
    assert dataclasses.asdict(tcfg)["slstm_layers"] == (1,)
    assert tcfg.n_heads == 4 and 2 * tcfg.d_model // tcfg.n_heads == 64
