"""The hybrid and SSM families at their published widths and depth
(zamba2-1.2b, 38 layers; xlstm-125m, 12 layers): the stepwise decode that
serves them (the reference's prefill hands decode no recurrent state)
against the prefill, in the port and in the reference, with the
reference's weights carried across.

At full depth the reference's own stepwise decode and prefill differ
past its bf16 bar (atol 0.15 / rtol 0.1): the bounds below are what it
shows, measured here, and the port is held to them.  `chip_smoke.py`'s
`lm_families` phase holds these two configs' stepwise decode on the card
at about twice the reference's largest relative L2 for that reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.models import transformer as rt
from repro_torch.configs import registry as treg
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.models import transformer as tt

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the JAX package's own relative L2 between its stepwise decode and its
# prefill at full depth, positions 0-3 (bf16): (low, high) bounds
REFERENCE_DRIFT = {"zamba2-1.2b": (0.02, 0.08), "xlstm-125m": (0.05, 0.15)}


@pytest.mark.parametrize("name", sorted(REFERENCE_DRIFT))
def test_full_depth_stepwise_drift_is_the_references(name):
    """zamba2-1.2b (38 layers) and xlstm-125m (12 layers) at their
    published widths and depth, the reference's weights carried across, 4
    positions of 2 requests: the stepwise decode from the zero state
    against the prefill's logits at each position.  In bf16 both packages
    drift apart from their own prefill by the same few percent, past the
    atol 0.15 / rtol 0.1 bar in the reference itself (its causal convs
    round in bf16 in the prefill and sum in float32 in decode; the
    chunked scans sum in other orders than the recurrences; the error
    grows with depth), while in float32 the port's agree to 1e-4
    (relative).  The port's relative L2 stays within 1.25x (+0.01) of the
    reference's at every position, and its stepwise logits differ from
    the reference's by no more than the larger of the two drifts."""
    rcfg, tcfg = rreg.get_arch(name), treg.get_arch(name)
    params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg, RULES)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    B, n = 2, 4
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, n)).astype(
        np.int32)
    rfull = _np(rt.forward(params, rcfg, {"tokens": jnp.asarray(toks)})[0])
    tfull = _np(tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})[0])
    rs = rt.init_decode_state(rcfg, n, B)
    ts = tt.init_decode_state(tcfg, n, B, device="cpu")
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    lo, hi = REFERENCE_DRIFT[name]
    for i in range(n):
        rl, rs = rt.decode_step(params, rcfg, {
            "tokens": jnp.asarray(toks[:, i:i + 1]),
            "cur_len": jnp.int32(i)}, rs)
        tl, ts = tt.decode_step(tp, tcfg, {
            "tokens": torch.from_numpy(toks[:, i:i + 1].copy()),
            "cur_len": i}, ts)
        r_drift = rel(_np(rl)[:, 0], rfull[:, i])
        t_drift = rel(_np(tl)[:, 0], tfull[:, i])
        cross = rel(_np(tl), _np(rl))
        assert lo < r_drift < hi, (i, r_drift)
        assert t_drift <= 1.25 * r_drift + 0.01, (i, t_drift, r_drift)
        assert cross <= max(r_drift, t_drift), (i, cross, r_drift, t_drift)
