"""The port's flash attention package vs the reference's.

On the CPU the port's wrapper takes its plain-torch twin `mha_ref` (the
tensors lie on the CPU); the twin is held against the reference's jnp
oracle and against its Pallas kernel in interpret mode, at the shapes of
the reference's own tests (tests/test_kernels.py).  The CUDA kernels run
only on a GPU: tests/test_torch_cuda.py holds them against the twins there.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are the same float32 draws rounded to nearest on both sides).
Tolerances are the reference's own bars for its kernel against its oracle:
atol = rtol = 2e-5 in float32 (summation order of the online softmax) and
2e-2 in bfloat16 (one bf16 rounding of the output).  `flash_tc_ref`, the
twin of the bf16 tensor-core kernel, carries P into P.V as two bf16
parts (hi + lo) and scales after the product; it is held to the
reference at the bf16 bar, and a reduced qwen3-4b through it to the
reference's model at the reference's bar for two bf16 computations of the
same logits (atol 0.15, rtol 0.1, tests/test_models_smoke.py).
`flash_tf32x3_ref`, the twin of the float32 kernel, takes both products
as three TF32 products (each operand split into big + small TF32 parts);
it is held to the reference at the float32 bar, and its one-part variant
is shown to miss that bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref
from repro.models import transformer as rt
from repro_torch.configs import registry as treg
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     plan_flash_attention)
from repro_torch.kernels.flash_attention.ref import (flash_tc_ref,
                                                     flash_tf32x3_ref,
                                                     mha_ref, tf32_round)
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, H, KH, S, dh, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, h, S, dh), dtype=np.float32)
            for h in (H, KH, KH)]
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _pallas(jq, jk, jv, *, causal, window=0, bq=64, bk=64):
    """The reference's kernel in interpret mode on (B, H, S, dh) inputs."""
    B, H, S, dh = jq.shape
    KH = jk.shape[1]
    o = flash_attention_pallas(
        jq.reshape(B * H, S, dh), jk.reshape(B * KH, S, dh),
        jv.reshape(B * KH, S, dh), causal=causal, window=window, bq=bq,
        bk=bk, interpret=True)
    return np.asarray(o.reshape(B, H, S, dh), np.float32)


def _close(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,S,dh", [
    (1, 4, 4, 256, 64),     # MHA
    (2, 8, 2, 128, 64),     # GQA
    (1, 4, 1, 256, 128),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_twin_matches_reference(B, H, KH, S, dh, causal,
                                                dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * 1000 + H, B, H, KH, S, dh,
                                         dtype)
    want = np.asarray(r_mha_ref(jq, jk, jv, causal=causal), np.float32)
    pallas = _pallas(jq, jk, jv, causal=causal)
    before = cuda_lib.LAUNCHES["flash_attention"]
    for got in (mha_ref(tq, tk, tv, causal=causal),
                flash_attention(tq, tk, tv, causal=causal),
                flash_attention(tq, tk, tv, causal=causal, backend="torch")):
        assert got.dtype == TORCH[dtype] and got.shape == (B, H, S, dh)
        _close(got, want, dtype)
        _close(got, pallas, dtype)
    # CPU tensors take the twin: no kernel launch is counted
    assert cuda_lib.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("window", [64, 192])
def test_flash_attention_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(window, 1, 2, 2, 512, 64,
                                         "float32")
    want = np.asarray(r_mha_ref(jq, jk, jv, causal=True, window=window))
    pallas = _pallas(jq, jk, jv, causal=True, window=window)
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


@pytest.mark.parametrize("bq,bk", [(32, 64), (128, 32)])
def test_flash_attention_block_shape_sweep(bq, bk):
    """The reference kernel's block shapes do not change the function the
    port's wrapper computes."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(42, 1, 2, 2, 256, 64, "float32")
    pallas = _pallas(jq, jk, jv, causal=True, bq=bq, bk=bk)
    _close(flash_attention(tq, tk, tv, causal=True), pallas, "float32")


@pytest.mark.parametrize("S,dh", [(200, 32), (65, 64)])
def test_twin_at_ragged_lengths_matches_reference_oracle(S, dh):
    """S not a multiple of 64 (the CUDA kernel masks its last tile; the
    reference's kernel asserts S % bq == 0, so only its oracle applies)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(S, 2, 4, 2, S, dh, "float32")
    for causal, window in ((True, 0), (False, 0), (True, 48)):
        want = np.asarray(r_mha_ref(jq, jk, jv, causal=causal,
                                    window=window))
        _close(flash_attention(tq, tk, tv, causal=causal, window=window),
               want, "float32")


def test_wrapper_rejects_unknown_backend():
    q = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, backend="pallas")


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KH,S,dh", [
    (1, 4, 4, 256, 64),     # MHA
    (2, 8, 2, 128, 64),     # GQA
    (1, 4, 1, 256, 128),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_twin_matches_reference(B, H, KH, S, dh, causal):
    """bf16, at the shapes of the reference's own kernel tests."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * 1000 + H, B, H, KH, S, dh,
                                         "bfloat16")
    got = flash_tc_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, dh)
    _close(got, np.asarray(r_mha_ref(jq, jk, jv, causal=causal), np.float32),
           "bfloat16")
    _close(got, _pallas(jq, jk, jv, causal=causal), "bfloat16")


@pytest.mark.parametrize("window", [64, 192])
def test_flash_tc_twin_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(window, 1, 2, 2, 512, 64,
                                         "bfloat16")
    got = flash_tc_ref(tq, tk, tv, causal=True, window=window)
    want = np.asarray(r_mha_ref(jq, jk, jv, causal=True, window=window),
                      np.float32)
    _close(got, want, "bfloat16")
    _close(got, _pallas(jq, jk, jv, causal=True, window=window), "bfloat16")


def test_flash_tc_twin_at_ragged_length():
    """S = 1,000 with GQA: the kernel's last kv tile is ragged (the
    reference's kernel asserts S % bq == 0, so only its oracle applies)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1000, 1, 8, 2, 1000, 128,
                                         "bfloat16")
    want = np.asarray(r_mha_ref(jq, jk, jv, causal=True), np.float32)
    _close(flash_tc_ref(tq, tk, tv, causal=True), want, "bfloat16")


def test_reduced_qwen3_through_flash_tc_twin_matches_reference(monkeypatch):
    """A reduced qwen3-4b forward whose attention is the bf16 kernel's
    twin, against the reference's model on the same weights and tokens."""
    rcfg = rreg.reduced_config(rreg.get_arch("qwen3-4b"))
    tcfg = treg.reduced_config(treg.get_arch("qwen3-4b"))
    params, _ = rt.init_model(jax.random.PRNGKey(0), rcfg,
                              ShardingRules(model_size=1, data_size=1,
                                            fsdp=False))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, size=(2, 160))
    toks = toks.astype(np.int32)
    calls = []

    def twin(q, k, v, *, causal, window):
        calls.append(q.dtype)
        return flash_tc_ref(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ta, "flash_attention", twin)
    got, _, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    want, _, _ = rt.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    assert calls == [torch.bfloat16] * tcfg.n_layers
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.15,
                               rtol=0.1)


# ---------------------------------------------------------------------------
# the float32 tensor-core kernel's twin: three TF32 products
# ---------------------------------------------------------------------------

# The reference's float32 kernel shapes (tests/test_kernels.py: MHA, GQA
# and MQA, causal and full; the windows 64 and 192) and dh 32.
F32_CASES = [
    (1, 4, 4, 256, 64, True, 0), (1, 4, 4, 256, 64, False, 0),
    (2, 8, 2, 128, 64, True, 0), (2, 8, 2, 128, 64, False, 0),
    (1, 4, 1, 256, 128, True, 0), (1, 4, 1, 256, 128, False, 0),
    (1, 2, 2, 512, 64, True, 64), (1, 2, 2, 512, 64, True, 192),
    (2, 4, 4, 256, 32, True, 0),
]


def _f32_case(B, H, KH, S, dh, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B * 1000 + H + window, B, H, KH, S,
                                         dh, "float32")
    want = np.asarray(r_mha_ref(jq, jk, jv, causal=causal, window=window),
                      np.float32)
    return (tq, tk, tv), want


@pytest.mark.parametrize("B,H,KH,S,dh,causal,window", F32_CASES)
def test_flash_tf32x3_twin_matches_reference(B, H, KH, S, dh, causal,
                                             window):
    """Three TF32 products keep the float32 bar (2e-5) against the JAX
    package's `mha_ref`."""
    (tq, tk, tv), want = _f32_case(B, H, KH, S, dh, causal, window)
    got = flash_tf32x3_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, dh)
    _close(got, want, "float32")


@pytest.mark.parametrize("B,H,KH,S,dh,causal,window", F32_CASES)
def test_one_tf32_part_misses_the_float32_bar(B, H, KH, S, dh, causal,
                                              window):
    """One TF32 part of each operand (what a plain TF32 product keeps)
    misses 2e-5 at every shape, so the split is what carries the bar."""
    (tq, tk, tv), want = _f32_case(B, H, KH, S, dh, causal, window)
    one = flash_tf32x3_ref(tq, tk, tv, causal=causal, window=window,
                           parts=1).numpy()
    three = flash_tf32x3_ref(tq, tk, tv, causal=causal, window=window)
    assert not np.allclose(one, want, atol=TOL["float32"],
                           rtol=TOL["float32"])
    assert np.abs(one - want).max() > 10 * np.abs(three.numpy() - want).max()


def _bits(u: int) -> torch.Tensor:
    return torch.tensor([u], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),                  # tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),            # negative tie
    (1 + 2 ** -11 - 2 ** -23, 1.0),                # just below the tie
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),               # tie, odd lower value
    (-3.0 * 2 ** -130, -3.0 * 2 ** -130),          # subnormal, exact
])
def test_tf32_round_ties_and_negatives(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("u,want", [
    (0x3F801FFF, 0x3F802000),    # low 13 bits all set: up one TF32 ulp
    (0xBF801FFF, 0xBF802000),    # the same, negative
    (0x3FFFFFFF, 0x40000000),    # carries into the exponent: 2.0
    (0x3F800FFF, 0x3F800000),    # below half an ulp: down
    (0xBF800FFF, 0xBF800000),
])
def test_tf32_round_low_bits(u, want):
    got = tf32_round(_bits(u)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert got.item() == want


def test_tf32_round_is_nearest_with_ties_away():
    """Against nearest-ties-away computed in float64 on seeded values of
    every magnitude and sign."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * np.exp2(rng.integers(-60, 60, 20000))
         ).astype(np.float32)
    x[:4] = [1 + 2 ** -11, -(1 + 2 ** -11), 2 ** -11, 3 * 2 ** -12]
    got = tf32_round(torch.from_numpy(x)).numpy().astype(np.float64)
    m = np.abs(x.astype(np.float64))
    ulp = np.exp2(np.floor(np.log2(m)) - 10)
    want = np.sign(x) * np.floor(m / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got, want)
    assert not (got.astype(np.float32).view(np.int32) & 0x1FFF).any()


# ---------------------------------------------------------------------------
# the wrapper's plan: layout, alignment and kernel choice
# ---------------------------------------------------------------------------


def test_plan_takes_model_layout_views_without_a_copy():
    """(B, S, heads, dh) activations seen as (B, heads, S, dh): the bf16
    kernel reads them in place through their strides."""
    x = torch.zeros(2, 96, 8, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 96, 2, 128, dtype=torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    plan = plan_flash_attention(q, k, k)
    assert plan.kernel == "flash_attention_tc"
    assert plan.q.data_ptr() == x.data_ptr()
    assert plan.k.data_ptr() == kv.data_ptr()
    assert plan.strides == ((96 * 8 * 128, 128, 8 * 128),
                            (96 * 2 * 128, 128, 2 * 128),
                            (96 * 2 * 128, 128, 2 * 128))
    assert (plan.B, plan.H, plan.KH, plan.S, plan.dh) == (2, 8, 2, 96, 128)
    # the output the wrapper allocates keeps q's strides
    assert torch.empty_like(plan.q).stride() == q.stride()


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "flash_attention_tc"),
    (torch.float32, "flash_attention"),
])
def test_plan_picks_kernel_by_dtype(dtype, kernel):
    """bf16 takes the wgmma kernel on the caller's views; float32 the
    TF32 tensor-core kernel on contiguous copies."""
    x = torch.zeros(2, 64, 4, 64, dtype=dtype).transpose(1, 2)
    plan = plan_flash_attention(x, x, x)
    assert plan.kernel == kernel
    if dtype == torch.float32:
        assert plan.q.is_contiguous() and plan.q.data_ptr() != x.data_ptr()
    else:
        assert plan.q is x
        assert plan.strides[0] == (64 * 4 * 64, 64, 4 * 64)


@pytest.mark.parametrize("make,what", [
    (lambda: torch.zeros(1, 4, 64, 256, dtype=torch.bfloat16)[..., ::2],
     "contiguous"),
    (lambda: torch.zeros(1, 4, 64, 132, dtype=torch.bfloat16)[..., :128],
     "multiples"),
    (lambda: torch.zeros(1 + 4 * 64 * 64, dtype=torch.bfloat16)[1:]
     .view(1, 4, 64, 64), "aligned"),
])
def test_plan_rejects_layouts_the_tma_cannot_read(make, what):
    x = make()
    with pytest.raises(ValueError, match=what):
        plan_flash_attention(x, x, x)


def test_plan_realigns_float32_inputs_for_the_kernels_16_byte_loads():
    """A contiguous float32 view whose base is 4 bytes past a 16-byte
    boundary is copied into fresh storage; an aligned one is taken as it
    lies."""
    x = torch.arange(1 + 2 * 64 * 32, dtype=torch.float32)[1:].view(
        1, 2, 64, 32)
    assert x.is_contiguous() and x.data_ptr() % 16
    plan = plan_flash_attention(x, x, x)
    assert plan.q.data_ptr() % 16 == 0 and plan.q.is_contiguous()
    assert torch.equal(plan.q, x)
    y = torch.zeros(1, 2, 64, 32)
    assert plan_flash_attention(y, y, y).q is y


def test_plan_ignores_strides_of_size_one_dimensions():
    """A dimension of size 1 is never stepped, so its stride need not be
    a 16-byte multiple (here 130 elements): the plan gives the TMA dh."""
    x = torch.zeros(1, 1, 1, 130, dtype=torch.bfloat16)[..., :128]
    assert plan_flash_attention(x, x, x).strides[0] == (128, 128, 128)


def test_plan_rejects_bad_shapes_and_types():
    q = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        plan_flash_attention(q, q[:, :3], q[:, :3])        # H % KH != 0
    with pytest.raises(ValueError):
        odd = torch.zeros(1, 4, 64, 96, dtype=torch.bfloat16)
        plan_flash_attention(odd, odd, odd)                # dh = 96
    with pytest.raises(TypeError):
        h = q.half()
        plan_flash_attention(h, h, h)
    with pytest.raises(TypeError):
        plan_flash_attention(q, q.float(), q)              # mixed dtypes
    with pytest.raises(ValueError):
        plan_flash_attention(q, q, q, window=-1)
