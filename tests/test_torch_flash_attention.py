"""The port's flash attention package vs the reference's.

On the CPU the port's wrapper takes its plain-torch twin `mha_ref` (the
tensors lie on the CPU); the twin is held against the reference's jnp
oracle and against its Pallas kernel in interpret mode, at the shapes of
the reference's own tests (tests/test_kernels.py).  The CUDA kernel runs
only on a GPU: tests/test_torch_cuda.py holds it against the twin there.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are the same float32 draws rounded to nearest on both sides).
Tolerances are the reference's own bars for its kernel against its oracle:
atol = rtol = 2e-5 in float32 (summation order of the online softmax) and
2e-2 in bfloat16 (one bf16 rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref

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
