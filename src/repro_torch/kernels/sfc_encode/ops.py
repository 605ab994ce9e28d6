"""Public wrappers for the SFC encode kernels (csrc/sfc_encode.cu), and
for the query split and its z-ranges built on the same encode
(`split_zranges`).

``backend="cuda"`` launches the CUDA kernel for CUDA tensors and uses the
plain-torch twin only for CPU tensors; ``backend="torch"`` always uses the
twin.  The curve reaches the kernel as data: its nibble lookup tables
(`core.curve.curve_lut`, `core.sfc.lut_tables`) and region bits, so one
compiled kernel serves global and piecewise curves alike, one curve or a
whole pool.  `plan_encode` picks where the kernel reads the tables from.
On ``meta`` tensors the kernel route allocates the outputs and launches
nothing (a shape-only run); on either device each call is one op to an
active step counter (`encode_work`), its table look-ups uncounted.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core.curve import CurvePool, as_curve, curve_lut, curve_tables
from ...core.curve import pack_curve_pool
from .. import cuda_lib
from .ref import pool_tables, sfc_encode_pool_ref, sfc_encode_ref

BACKENDS = ("cuda", "torch")

# The kernel's launch shape and the H100's shared memory (csrc/sfc_encode.cu)
THREADS = 256
POINTS_PER_THREAD = 4
BLOCKS_PER_SM = 8
SMEM_PER_SM = 233_472          # 228 KB an SM
MAX_STAGED_BYTES = 231_424     # 227 KB a block, less 1 KB of static arrays
BLOCK_RESERVED_BYTES = 1_536   # the runtime's 1 KB a block + static arrays
MAX_REGION_BITS = 30
MAX_K = 32
MAX_SPLIT_D = 16              # the split kernel's dims (its general instance)
MAX_SPLIT_K = 16              # and levels: 2^16 leaves a window


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    placement: str        # "smem" (staged with cp.async) or "l1" (__ldg)
    blocks: int           # point blocks per curve (the grid's x)
    table_bytes: int      # one curve's lookup tables


def nibbles(K: int) -> int:
    return -(-K // 4)


def plan_encode(n: int, P: int, R: int, d: int, K: int,
                sms: int) -> EncodePlan:
    """Where the kernel reads a curve's R*d*C*128-byte table from, and its
    grid, for n points under each of P curves on a card with `sms` SMs.
    The table is staged in shared memory when it fits (measured faster than
    L1 at every shape `bench.py` times, down to 256 points) and read
    through L1 otherwise."""
    table_bytes = R * d * nibbles(K) * 128
    return _plan(n, P, table_bytes, table_bytes <= MAX_STAGED_BYTES, sms)


def plan_split(Q: int, k: int, R: int, d: int, K: int,
               sms: int) -> EncodePlan:
    """`plan_encode`'s placement for the split kernel, whose grid covers
    the Q * 2^k leaves at one a thread."""
    table_bytes = R * d * nibbles(K) * 128
    return _plan(Q << k, 1, table_bytes, table_bytes <= MAX_STAGED_BYTES,
                 sms, per_block=THREADS)


def _plan(n: int, P: int, table_bytes: int, staged: bool, sms: int,
          per_block: int = THREADS * POINTS_PER_THREAD) -> EncodePlan:
    """The grid for a table staged or read through L1.  Blocks cover n at
    `per_block` items each, capped at what the card holds at once across
    the pool: 8 blocks an SM, or as many staged blocks as its shared memory
    holds."""
    per_sm = BLOCKS_PER_SM
    if staged:
        per_sm = min(per_sm,
                     SMEM_PER_SM // (table_bytes + BLOCK_RESERVED_BYTES))
    blocks = min(-(-n // per_block), max(1, sms * per_sm // P))
    return EncodePlan("smem" if staged else "l1", max(1, blocks),
                      table_bytes)


def encode_work(n: int, d: int, K: int, R: int, M: int, P: int = 1,
                shared: bool = True) -> int:
    """Bytes an encode of n points under P curves must move: the points in
    once (once per pool when shared), the Z64 out once per curve, and each
    curve's R*d*K bit positions and M live region bits (4 bytes each).
    The lookup tables are derived from the positions, so not counted."""
    return ((1 if shared else P) * n * d * 4 + P * n * 8
            + P * (R * d * K + M) * 4)


def split_work(Q: int, d: int, K: int, R: int, M: int, k: int) -> int:
    """Bytes the split of Q windows into 2^k leaves must move: the (Q, d, 2)
    int32 windows in, the (Q, 2^k) bool `valid` and the two (Q, 2^k, 2)
    int32 z-ranges out, and the curve once as `encode_work` counts it (its
    R*d*K bit positions and M live region bits, 4 bytes each)."""
    return Q * d * 8 + (Q << k) * (1 + 16) + (R * d * K + M) * 4


def _live_region_bits(reg, T: int) -> int:
    """The most live region bits (entries below T) of any curve of a
    (P, M) table; every entry when the table holds shapes only."""
    if isinstance(reg, torch.Tensor):
        if reg.device.type == "meta":
            return int(reg.shape[-1])
        reg = reg.cpu()
    reg = torch.as_tensor(reg).reshape(-1, reg.shape[-1])
    return int((reg < T).sum(1).max()) if reg.numel() else 0


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")


def _check_tables(reg, lut, P: int, d: int, K: int) -> None:
    """Raise unless reg (P, M) int32 and lut (P, R, d, C, 16) int64 are
    contiguous CUDA tensors that the kernel takes."""
    cuda_lib.check_cuda_int32("reg", reg, 2)
    cuda_lib.check_cuda("lut", lut, torch.int64, 5)
    if not 1 <= K <= MAX_K or d * K > 64:
        raise ValueError(f"the kernel takes K <= {MAX_K} and d*K <= 64; "
                         f"got d={d}, K={K}")
    if reg.shape[0] != P or reg.shape[1] > MAX_REGION_BITS:
        raise ValueError(f"reg must be ({P}, M <= {MAX_REGION_BITS}); got "
                         f"{tuple(reg.shape)}")
    if (lut.shape[0] != P or lut.shape[1] < 1
            or tuple(lut.shape[2:]) != (d, nibbles(K), 16)):
        raise ValueError(f"lut must be ({P}, R, {d}, {nibbles(K)}, 16); got "
                         f"{tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError("lut must be 16-byte aligned")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sfc_encode(x, curve, *, backend: str = "cuda"):
    """x: (n, d) int32 -> (n, 2) int32 Z64.  `curve` is any
    `MonotonicCurve` (legacy `Theta` values are coerced)."""
    curve = as_curve(curve)
    _check_backend(backend)
    if backend == "torch" or x.device.type == "cpu":
        return sfc_encode_ref(x, curve)
    cuda_lib.check_cuda_int32("x", x, 2)
    n, d = x.shape
    if d != curve.d:
        raise ValueError(f"x has {d} dims; the curve has {curve.d}")
    with cuda_lib.uncounted():
        _, reg = curve_tables(curve, x.device)
        lut = curve_lut(curve, x.device)
    _check_tables(reg[None], lut[None], 1, d, curve.K)
    out = torch.empty((n, 2), dtype=torch.int32, device=x.device)
    if n:
        R = lut.shape[0]
        if cuda_lib.on_card(x):
            plan = plan_encode(n, 1, R, d, curve.K, _sms(x.device))
            cuda_lib.launch("sfc_encode_launch", x.data_ptr(),
                            lut.data_ptr(), reg.data_ptr(), out.data_ptr(),
                            n, d, curve.K, R, reg.shape[0],
                            plan.placement == "smem", plan.blocks)
            cuda_lib.LAUNCHES["sfc_encode"] += 1
        cuda_lib.count_kernel("sfc_encode", lambda: (
            0, encode_work(n, d, curve.K, R, _live_region_bits(
                curve_tables(curve, "cpu")[1], d * curve.K)),
            (tuple(x.shape),), out))
    return out


def sfc_encode_pool(x, curves, *, backend: str = "cuda"):
    """Candidate-batched encode: x (n, d) int32 shared by every curve, or
    (P, n, d) int32 with one point set per curve; `curves` a `CurvePool`
    (numpy or tensor arrays, its ``lut`` built here when it carries none)
    or a list of `MonotonicCurve`s sharing (d, K) -> (P, n, 2) int32 Z64.
    One launch encodes under every curve."""
    _check_backend(backend)
    pool = curves if isinstance(curves, CurvePool) else pack_curve_pool(
        curves)
    if backend == "torch" or x.device.type == "cpu":
        return sfc_encode_pool_ref(x, pool)
    cuda_lib.check_cuda_int32("x", x, 3 if x.dim() == 3 else 2)
    with cuda_lib.uncounted():
        reg, lut = pool_tables(pool, x.device)
    P = len(pool)
    n, d = x.shape[-2:]
    if x.dim() == 3 and x.shape[0] != P:
        raise ValueError(f"x has {x.shape[0]} point sets for {P} curves")
    if d != pool.d:
        raise ValueError(f"x has {d} dims; the pool's curves have {pool.d}")
    _check_tables(reg, lut, P, d, pool.K)
    out = torch.empty((P, n, 2), dtype=torch.int32, device=x.device)
    if n and P:
        R = lut.shape[1]
        if cuda_lib.on_card(x):
            plan = plan_encode(n, P, R, d, pool.K, _sms(x.device))
            x_stride = n * d if x.dim() == 3 else 0
            cuda_lib.launch("sfc_encode_pool_launch", x.data_ptr(),
                            x_stride, lut.data_ptr(), reg.data_ptr(),
                            out.data_ptr(), n, d, pool.K, R, reg.shape[1], P,
                            plan.placement == "smem", plan.blocks)
            cuda_lib.LAUNCHES["sfc_encode_pool"] += 1
        cuda_lib.count_kernel("sfc_encode_pool", lambda: (
            0, encode_work(n, d, pool.K, R, _live_region_bits(
                pool.reg, d * pool.K), P, shared=x.dim() == 2),
            (tuple(x.shape),), out))
    return out


def split_zranges(queries, curve, k_maxsplit: int, *,
                  backend: str = "cuda"):
    """The query split and its z-ranges in one launch: queries (Q, d, 2)
    int32 (unsigned bit patterns) -> (valid (Q, 2^k) bool, zlo, zhi
    (Q, 2^k, 2) int32 Z64), bit for bit `core.split.recursive_split_torch`
    then `zranges_torch`, invalid leaves included.  That composition is
    the twin, taken for CPU tensors and under ``backend="torch"``."""
    curve = as_curve(curve)
    _check_backend(backend)
    if backend == "torch" or queries.device.type == "cpu":
        # core.split imports this module for its encodes
        from ...core.split import recursive_split_torch, zranges_torch
        rects, valid = recursive_split_torch(queries, curve, k_maxsplit,
                                             backend=backend)
        return (valid, *zranges_torch(rects, curve, backend=backend))
    cuda_lib.check_cuda_int32("queries", queries, 3)
    Q, d, two = queries.shape
    if two != 2 or d != curve.d:
        raise ValueError(f"queries must be (Q, {curve.d}, 2) for the curve; "
                         f"got {tuple(queries.shape)}")
    if d > MAX_SPLIT_D or not 0 <= k_maxsplit <= MAX_SPLIT_K:
        raise ValueError(f"the split kernel takes d <= {MAX_SPLIT_D} and "
                         f"0 <= k_maxsplit <= {MAX_SPLIT_K}; got d={d}, "
                         f"k_maxsplit={k_maxsplit}")
    with cuda_lib.uncounted():
        _, reg = curve_tables(curve, queries.device)
        lut = curve_lut(curve, queries.device)
    _check_tables(reg[None], lut[None], 1, d, curve.K)
    S = 1 << k_maxsplit
    valid = torch.empty((Q, S), dtype=torch.bool, device=queries.device)
    zlo, zhi = torch.empty((2, Q, S, 2), dtype=torch.int32,
                           device=queries.device).unbind(0)
    if Q:
        R = lut.shape[0]
        if cuda_lib.on_card(queries):
            plan = plan_split(Q, k_maxsplit, R, d, curve.K,
                              _sms(queries.device))
            cuda_lib.launch("split_zranges_launch", queries.data_ptr(),
                            lut.data_ptr(), reg.data_ptr(), valid.data_ptr(),
                            zlo.data_ptr(), zhi.data_ptr(), Q, d, curve.K, R,
                            reg.shape[0], k_maxsplit,
                            plan.placement == "smem", plan.blocks)
            cuda_lib.LAUNCHES["split_zranges"] += 1
        cuda_lib.count_kernel("split_zranges", lambda: (
            0, split_work(Q, d, curve.K, R, _live_region_bits(
                curve_tables(curve, "cpu")[1], d * curve.K), k_maxsplit),
            (tuple(queries.shape), tuple(valid.shape)), (valid, zlo, zhi)))
    return valid, zlo, zhi
