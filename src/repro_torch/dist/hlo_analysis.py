"""Loop-aware analyzer over post-optimization HLO text, and the port's
step counter.

*The analyzer* is a copy of the reference's (`repro.dist.hlo_analysis`):
``jax.stages.Compiled.cost_analysis()`` counts every computation once, so a
``lax.scan`` over 88 layers reports ~1/88 of the real flops.  It re-derives
flops / HBM traffic / collective wire bytes from ``compiled.as_text()``
instead, multiplying ``while`` body costs by the trip count.  All numbers
are *per device*: the partitioned module already carries local shapes.
It differs from the reference in one place, the trip count: it reads the
``known_trip_count`` that newer XLA writes into the while op's
``backend_config`` before it looks for a compare against a constant (the
reference counts each such loop once).  It reads HLO text that a JAX
program wrote; the port itself makes none.

*The step counter* (`StepCounter`) is the port's counterpart of lowering
and compiling a step: a ``TorchDispatchMode`` under which the step runs
once, on ``meta`` tensors (shapes only, nothing allocated) or on the card,
recording every aten op:

  flops   — ``torch.utils.flop_counter``'s registered formulas, so matmul,
            bmm, addmm and the rest agree with ``FlopCounterMode``;
  bytes   — the op's tensor inputs plus its fresh outputs (an in-place or
            ``out=`` op counts its destination once); views and other
            metadata ops are free, as ``_NO_TRAFFIC`` opcodes are here,
            and so are copies between the host and a device (uploads of
            a batch or of host-made tables are the analyzer's parameters
            and constants);
            Eager PyTorch runs every op as its own kernel, so there is no
            fusion: ``bytes_unfused`` equals ``bytes``;
  wire    — c10d and functional collectives, with the analyzer's ring
            formulas (`_ring_wire_bytes`) over the process group's size;
  kernels — each hand-written kernel's wrapper records one op of the
            kernel's own work (`record_kernel`, called through
            `kernels.cuda_lib.count_kernel`) and nothing of its internals.

`StepCounter.analyze` returns the same dict as `analyze_hlo_text`.  The
counter also tracks the peak of live tensor storage made during the step
(`peak_bytes`), and can keep an op log aggregated by (op, input shapes,
innermost `repro_torch` source line), the counterpart of HLO ``op_name``
metadata: one row per distinct key, with a count.

Outputs (``analyze_hlo_text`` and ``StepCounter.analyze``):
  flops          — dot/convolution flops, trip-count weighted
  bytes          — HBM traffic with fusions as emitted (operands + outputs
                   of every traffic-bearing op; fusions count as one op)
  bytes_unfused  — upper bound with every fusion expanded to its body ops
  wire_bytes     — per-collective link traffic (ring-algorithm accounting)
  collectives    — {base opcode: {"count": n, "bytes": wire_bytes}}
"""
from __future__ import annotations

import os
import re
import sys
import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry

from ..kernels import cuda_lib

# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "f8e4m3fnuz": 1, "f8e5m2fnuz": 1, "f8e3m4": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# a dtype token must directly abut '[' — "replica_groups=[2,4]" has '=' in
# between and therefore never matches as a shape
_SHAPE_RE = re.compile(r"\b([a-z][a-z0-9]*)\[([0-9,]*)\]")


def _dims(dim_str: str) -> list:
    return [int(d) for d in dim_str.split(",") if d]


def _shape_bytes(shape: str) -> int:
    """Total bytes of a (possibly tuple) HLO shape string; strings that are
    not shapes (e.g. replica_groups annotations) contribute 0."""
    total = 0
    for dtype, dim_str in _SHAPE_RE.findall(shape):
        size = _DTYPE_BYTES.get(dtype)
        if size is None:
            continue
        n = 1
        for d in _dims(dim_str):
            n *= d
        total += n * size
    return total


def _shape_dims(shape: str) -> list:
    """Dims of the first array shape in the string ([] for scalars/unknown)."""
    m = _SHAPE_RE.search(shape)
    return _dims(m.group(2)) if m else []


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


# --------------------------------------------------------------------------
# parsing
# --------------------------------------------------------------------------

_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_OP_HEAD_RE = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*")
_OPCODE_RE = re.compile(r"\s*([\w\-]+)\(")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_CALL_ATTR_RE = re.compile(r"(?:to_apply|calls)=%?([\w.\-]+)")
_INT_RE = re.compile(r"-?\d+")
_KNOWN_TRIP_RE = re.compile(
    r'"known_trip_count"\s*:\s*\{\s*"n"\s*:\s*"(\d+)"')

_COLLECTIVES = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast"}

# opcodes that move no HBM traffic of their own
_NO_TRAFFIC = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "after-all", "partition-id", "replica-id",
               "domain", "opt-barrier", "get-dimension-size"}

# post-fusion ops that anchor real HBM traffic (used by launch/attribute.py
# to pick the rows worth displaying)
_FUSED_ANCHORS = {"fusion", "dot", "convolution", "custom-call", "copy",
                  "copy-start", "gather", "scatter", "reduce", "sort",
                  "dynamic-slice", "dynamic-update-slice", "reduce-window",
                  "select-and-scatter", "cholesky", "triangular-solve",
                  "concatenate", "pad", "rng", "rng-bit-generator",
                  "while", "conditional"}


@dataclass
class HloOp:
    name: str
    shape: str      # result shape string (may be a tuple shape)
    opcode: str
    rest: str       # operand list + attributes, from the opening paren on

    operands: list = field(default_factory=list)


def _split_result_shape(s: str):
    """Split '  <shape> <opcode>(...' -> (shape, remainder) handling tuple
    shapes with nested parens."""
    s = s.lstrip()
    if s.startswith("("):
        depth = 0
        for i, c in enumerate(s):
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    return s[:i + 1], s[i + 1:]
        return s, ""
    m = re.match(r"[\w\[\],<=]+(?:\{[^}]*\})?", s)
    if m:
        return m.group(0), s[m.end():]
    return "", s


def _operand_segment(rest: str) -> str:
    """The balanced '(...)' operand list at the start of ``rest``."""
    if not rest.startswith("("):
        return ""
    depth = 0
    for i, c in enumerate(rest):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return rest[:i + 1]
    return rest


def _parse_op(line: str):
    m = _OP_HEAD_RE.match(line)
    if not m:
        return None
    name = m.group(1)
    shape, tail = _split_result_shape(line[m.end():])
    om = _OPCODE_RE.match(tail)
    if not om:
        return None
    opcode = om.group(1)
    rest = tail[om.end() - 1:]  # keep the opening paren
    op = HloOp(name=name, shape=shape, opcode=opcode, rest=rest)
    op.operands = _OPERAND_RE.findall(_operand_segment(rest))
    return op


def parse_computations(text: str):
    """-> (dict comp_name -> [HloOp], entry_comp_name)."""
    comps = {}
    entry = None
    cur = None
    for line in text.splitlines():
        if cur is None:
            m = _COMP_RE.match(line)
            if m:
                cur = m.group(2)
                comps[cur] = []
                if m.group(1):
                    entry = cur
            continue
        if line.startswith("}"):
            cur = None
            continue
        op = _parse_op(line)
        if op is not None:
            comps[cur].append(op)
    if entry is None and comps:
        entry = next(iter(comps))
    return comps, entry


# --------------------------------------------------------------------------
# analyzer
# --------------------------------------------------------------------------


class HloAnalyzer:
    def __init__(self, text: str):
        self.comps, self.entry = parse_computations(text)
        self.shape_of = {}
        self.op_by_name = {}
        for ops in self.comps.values():
            for op in ops:
                self.shape_of[op.name] = op.shape
                self.op_by_name[op.name] = op
        m = re.search(r"num_partitions=(\d+)", text)
        self.num_partitions = int(m.group(1)) if m else 1
        self._cost_memo = {}

    # -- per-op primitives -------------------------------------------------

    def _operand_bytes(self, op: HloOp) -> int:
        return sum(_shape_bytes(self.shape_of.get(n, ""))
                   for n in op.operands)

    def _op_traffic(self, op: HloOp) -> float:
        """operand reads + result write, in bytes."""
        return self._operand_bytes(op) + _shape_bytes(op.shape)

    def _group_size(self, op: HloOp) -> int:
        """Participants per replica group of a collective."""
        m = re.search(r"replica_groups=\{\{([^}]*)\}", op.rest)
        if m:
            return max(1, len([x for x in m.group(1).split(",") if x.strip()]))
        m = re.search(r"replica_groups=\[([\d,]+)\]<=", op.rest)
        if m:  # iota format [groups, group_size]
            dims = _dims(m.group(1))
            return dims[-1] if dims else 1
        if re.search(r"replica_groups=\{\}", op.rest):
            return self.num_partitions
        return self.num_partitions

    def _collective_payload(self, op: HloOp) -> int:
        """Payload bytes of a collective.  Async '-start' ops return a
        tuple aliasing (input, output); summing it double-counts, so take
        the largest single component instead."""
        out = _shape_bytes(op.shape)
        if op.opcode.endswith("-start") and op.shape.lstrip().startswith("("):
            comps = [_DTYPE_BYTES.get(d, 0) * _prod(_dims(s))
                     for d, s in _SHAPE_RE.findall(op.shape)]
            out = max(comps, default=0)
        return max(self._operand_bytes(op), out)

    def _wire_bytes(self, op: HloOp, base: str) -> float:
        """Ring-algorithm per-device link bytes for one collective."""
        n = self._collective_payload(op)
        g = self._group_size(op)
        if g <= 1:
            return 0.0
        if base == "all-reduce":
            return 2.0 * n * (g - 1) / g
        if base == "collective-permute":
            return float(n)
        return n * (g - 1) / g

    def _trip_count(self, cond_comp: str, while_op: HloOp = None) -> int:
        """Trip count of a while loop: the ``known_trip_count`` that XLA
        writes into the while op's ``backend_config`` when it has one, else
        from its condition computation: find the ROOT compare against a
        constant (counting loops emitted by lax.scan / fori_loop compare an
        induction var with direction LT/LE).  Unknown patterns
        conservatively report 1.

        The reference reads only the condition.  Newer XLA compares two
        loop-carried values (``compare(%param_0, %param_1)``) and states the
        count only in ``backend_config``, so the reference counts every
        such loop once; this is the one place the copy differs."""
        if while_op is not None:
            m = _KNOWN_TRIP_RE.search(while_op.rest)
            if m:
                return max(1, int(m.group(1)))
        consts = {}
        for op in self.comps.get(cond_comp, []):
            if op.opcode == "constant":
                m = _INT_RE.search(_operand_segment(op.rest))
                if m:
                    consts[op.name] = int(m.group(0))
        for op in self.comps.get(cond_comp, []):
            if op.opcode != "compare":
                continue
            d = re.search(r"direction=(\w+)", op.rest)
            if not d or len(op.operands) != 2:
                continue
            lhs, rhs = op.operands
            direction = d.group(1)
            if rhs in consts:        # iv <cmp> C
                c = consts[rhs]
                if direction == "LT":
                    return max(1, c)
                if direction == "LE":
                    return max(1, c + 1)
                if direction in ("GT", "GE"):  # count-down from unknown start
                    return 1
            if lhs in consts:        # C <cmp> iv
                c = consts[lhs]
                if direction == "GT":
                    return max(1, c)
                if direction == "GE":
                    return max(1, c + 1)
        return 1

    def _dot_flops(self, op: HloOp) -> float:
        """2 * |output| * contraction size (batch dims handled implicitly:
        they appear in the output and not in the contraction)."""
        out = _prod(_shape_dims(op.shape))
        contract = 1
        m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.rest)
        if m and op.operands:
            lhs_dims = _shape_dims(self.shape_of.get(op.operands[0], ""))
            for i in _dims(m.group(1)):
                if i < len(lhs_dims):
                    contract *= lhs_dims[i]
        return 2.0 * out * contract

    def _conv_flops(self, op: HloOp) -> float:
        """2 * |output| * (kernel taps per output element)."""
        out = _prod(_shape_dims(op.shape))
        if len(op.operands) < 2:
            return 2.0 * out
        kdims = _shape_dims(self.shape_of.get(op.operands[1], ""))
        taps = _prod(kdims)
        m = re.search(r"dim_labels=\w+_(\w+)->", op.rest)
        if m and kdims:
            o_pos = m.group(1).find("o")
            if 0 <= o_pos < len(kdims):
                taps //= max(1, kdims[o_pos])
        return 2.0 * out * taps

    # -- recursive cost ----------------------------------------------------

    def _comp_cost(self, comp: str):
        """(flops, bytes, bytes_unfused, wire, {base: [count, bytes]})."""
        if comp in self._cost_memo:
            return self._cost_memo[comp]
        # memoize-before-recurse guard against (malformed) cycles
        self._cost_memo[comp] = (0.0, 0.0, 0.0, 0.0, {})
        flops = nbytes = unfused = wire = 0.0
        colls = defaultdict(lambda: [0, 0.0])

        def absorb(sub, mult=1):
            nonlocal flops, nbytes, unfused, wire
            sf, sb, su, sw, sc = sub
            flops += sf * mult
            nbytes += sb * mult
            unfused += su * mult
            wire += sw * mult
            for k, (c, b) in sc.items():
                colls[k][0] += c * mult
                colls[k][1] += b * mult

        for op in self.comps.get(comp, []):
            oc = op.opcode
            if oc == "while":
                cm = re.search(r"condition=%?([\w.\-]+)", op.rest)
                bm = re.search(r"body=%?([\w.\-]+)", op.rest)
                trip = self._trip_count(cm.group(1), op) if cm else 1
                if bm:
                    absorb(self._comp_cost(bm.group(1)), trip)
                continue
            if oc in ("call", "async-start"):
                m = _CALL_ATTR_RE.search(op.rest)
                if m:
                    absorb(self._comp_cost(m.group(1)))
                continue
            if oc == "conditional":
                branches = re.search(r"branch_computations=\{([^}]*)\}",
                                     op.rest)
                names = (_OPERAND_RE.findall(branches.group(1))
                         if branches else
                         re.findall(r"(?:true|false)_computation=%?([\w.\-]+)",
                                    op.rest))
                if names:  # one branch executes; bound with the costliest
                    absorb(max((self._comp_cost(n) for n in names),
                               key=lambda c: (c[0], c[1])))
                continue
            if oc == "fusion":
                m = _CALL_ATTR_RE.search(op.rest)
                traffic = self._op_traffic(op)
                nbytes += traffic
                if m:
                    sub = self._comp_cost(m.group(1))
                    flops += sub[0]
                    unfused += max(sub[2], traffic)
                else:
                    unfused += traffic
                continue
            if oc in _NO_TRAFFIC:
                continue

            base = oc[:-6] if oc.endswith("-start") else oc
            if oc.endswith("-done") or oc.endswith("-update"):
                continue  # paired with the -start that carried the cost
            if base in _COLLECTIVES:
                w = self._wire_bytes(op, base)
                wire += w
                colls[base][0] += 1
                colls[base][1] += w
                traffic = self._operand_bytes(op) + self._collective_payload(op)
                nbytes += traffic
                unfused += traffic
                continue
            if oc == "dot":
                flops += self._dot_flops(op)
            elif oc == "convolution":
                flops += self._conv_flops(op)
            traffic = self._op_traffic(op)
            nbytes += traffic
            unfused += traffic

        result = (flops, nbytes, unfused, wire, dict(colls))
        self._cost_memo[comp] = result
        return result

    def analyze(self) -> dict:
        flops, nbytes, unfused, wire, colls = self._comp_cost(self.entry)
        return {
            "flops": int(flops),
            "bytes": float(nbytes),
            "bytes_unfused": float(unfused),
            "wire_bytes": float(wire),
            "collectives": {k: {"count": int(c), "bytes": float(b)}
                            for k, (c, b) in sorted(colls.items())},
        }


def analyze_hlo_text(text: str) -> dict:
    """Per-device flops / traffic / wire accounting of a partitioned,
    optimized HLO module (``compiled.as_text()``)."""
    return HloAnalyzer(text).analyze()


# --------------------------------------------------------------------------
# the step counter
# --------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(_PKG_DIR)
_KERNELS_DIR = os.path.join(_PKG_DIR, "kernels") + os.sep
_THIS_FILE = os.path.abspath(__file__)


def _ops(*names) -> set:
    """The OpOverloads named ``ns.op.overload`` that this torch has."""
    out = set()
    for name in names:
        ns, op, overload = name.split(".")
        packet = getattr(getattr(torch.ops, ns), op, None)
        if packet is not None and hasattr(packet, overload):
            out.add(getattr(packet, overload))
    return out


# metadata queries: left to the default handling, as FlopCounterMode does
_META_QUERIES = _ops(
    "aten.sym_is_contiguous.default", "aten.is_contiguous.default",
    "aten.is_contiguous.memory_format", "aten.is_strides_like_format.default",
    "aten.is_non_overlapping_and_dense.default", "aten.size.default",
    "aten.sym_size.default", "aten.stride.default", "aten.sym_stride.default",
    "aten.storage_offset.default", "aten.sym_storage_offset.default",
    "aten.numel.default", "aten.sym_numel.default", "aten.dim.default",
    "prim.layout.default")
_PRIM_DEVICE = _ops("prim.device.default")
_COPIES = _ops("aten._to_copy.default", "aten.copy_.default")

# ops that move no HBM traffic of their own (besides views, found from the
# schema): allocation without a fill, aliasing, waits (the counterpart of
# `_NO_TRAFFIC`)
_FREE = _ops(
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.detach.default",
    "aten.alias.default", "aten.lift_fresh.default", "aten.resize_.default",
    "aten.set_.source_Storage", "aten.set_.source_Storage_storage_offset",
    "aten.set_.source_Tensor", "aten.record_stream.default",
    "c10d.barrier.default", "_c10d_functional.wait_tensor.default",
    "_c10d_functional._wrap_tensor_autograd.default") | _PRIM_DEVICE

# c10d / functional collective op names -> the analyzer's base opcodes
_COLLECTIVE_OPS = (("reduce_scatter", "reduce-scatter"),
                   ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                   ("all_gather", "all-gather"), ("allgather", "all-gather"),
                   ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                   ("broadcast", "collective-broadcast"),
                   ("send", "collective-permute"),
                   ("recv", "collective-permute"))


def _ring_wire_bytes(base: str, n: float, g: int) -> float:
    """`HloAnalyzer._wire_bytes` for a payload of `n` bytes over a group of
    `g`: ring all-reduce 2n(g-1)/g, a permute n, the others n(g-1)/g."""
    if g <= 1:
        return 0.0
    if base == "all-reduce":
        return 2.0 * n * (g - 1) / g
    if base == "collective-permute":
        return float(n)
    return n * (g - 1) / g


def _collective_base(func):
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    for key, base in _COLLECTIVE_OPS:
        if key in name:
            return base
    return None


def _process_group_size(args) -> int:
    """Size of the process group a collective names (a c10d
    ``ProcessGroup`` argument or a functional op's group name); the world
    size when none resolves."""
    import torch.distributed as dist
    for a in args:
        try:
            if isinstance(a, torch.ScriptObject):
                return dist.ProcessGroup.unbox(a).size()
            if isinstance(a, str):
                return dist.distributed_c10d._resolve_process_group(a).size()
        except (RuntimeError, ValueError, KeyError, TypeError):
            continue    # not a process group (a reduce op, a tag)
    return dist.get_world_size() if dist.is_initialized() else 1


class _OpInfo:
    """What the counter needs of an op's schema, worked out once an op."""
    __slots__ = ("name", "view", "fresh", "collective", "decomposes",
                 "cacheable")

    def __init__(self, func):
        rets = func._schema.returns
        self.name = str(func)
        self.view = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)
        self.fresh = tuple(r.alias_info is None for r in rets)
        self.collective = _collective_base(func)
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        self.decomposes = (dk in func.py_kernels or torch._C.
                           _dispatch_has_kernel_for_dispatch_key(
                               func.name(), dk))
        # a functional op whose outputs are all fresh: on meta its output
        # shapes follow from its inputs' alone (`_MetaCache`)
        self.cacheable = (bool(rets) and all(self.fresh)
                          and not func._schema.is_mutable
                          and self.collective is None
                          and func.namespace == "aten")


_INFO = {}


def _info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        info = _INFO[func] = _OpInfo(func)
    return info


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs: tensors, and tensors in
    (nested) lists, tuples and dicts."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _meta_key(x):
    """A hashable stand-in for an argument: a tensor by its metadata, a
    sequence element by element; raises `_Uncacheable` for anything else
    (a tensor off meta, a tensor subclass such as a DTensor, whose op runs
    its own dispatch, an object)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or type(x) is not torch.Tensor:
            raise _Uncacheable      # off meta, or a subclass (a DTensor)
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_meta_key(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return x
    raise _Uncacheable


class _Uncacheable(Exception):
    pass


class _MetaCache:
    """Output metadata of functional aten ops on meta tensors, by op and
    input metadata.  Many meta kernels are Python references (100-500 µs
    a call); a model's layers repeat the same ops at the same shapes, so each
    is run once and later calls get empty outputs of the recorded shapes,
    strides and dtypes (what torch's fake-tensor dispatch cache does)."""

    def __init__(self):
        self.table = {}

    def run(self, func, args, kwargs):
        try:
            key = (func, _meta_key(args),
                   tuple(sorted((k, _meta_key(v)) for k, v in
                                kwargs.items())))
        except _Uncacheable:
            return func(*args, **kwargs)
        spec = self.table.get(key)
        if spec is not None:
            return _build(spec)
        out = func(*args, **kwargs)
        spec = _spec(out)
        if spec is not None:
            self.table[key] = spec
        return out


def _spec(out):
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta" or out.storage_offset():
            return None
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        parts = [_spec(o) for o in out]
        if any(p is None for p in parts):
            return None
        return (type(out),) + tuple(parts)
    return None


def _build(spec):
    if spec[0] == "T":
        _, shape, stride, dtype = spec
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="meta")
    return spec[0](_build(p) for p in spec[1:])


def _locals(tree):
    """`tree` with every DTensor replaced by its local block."""
    if isinstance(tree, DTensor):
        return tree._local_tensor
    if isinstance(tree, (list, tuple)):
        return type(tree)(_locals(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    return tree


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple (of a DTensor,
    its local block: one rank's bytes)."""
    return sum(_nbytes(getattr(t, "_local_tensor", t)) for t in _tensors(tree))


def _host_transfer(func, args, out) -> bool:
    """A copy between the host and a device (an upload of a batch or of a
    host-made table, or a download): no HBM traffic of the step, as the
    analyzer's parameters and constants are none."""
    if func not in _COPIES:
        return False
    src, dst = (args[0], out) if len(args) < 2 else (args[1], args[0])
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and (src.device.type == "cpu") != (dst.device.type == "cpu"))


def _source_line() -> str:
    """The innermost `repro_torch` line on the stack outside this module
    and the kernel wrappers (so a kernel op names its caller), relative to
    the package's parent; "(autograd)" on the autograd engine's own stack
    (a backward op)."""
    f = sys._getframe(2)
    while f is not None:
        rel = _SOURCE.get(f.f_code.co_filename)
        if rel is None:
            fn = f.f_code.co_filename
            rel = _SOURCE[fn] = (
                os.path.relpath(fn, _SRC_DIR) if fn.startswith(_PKG_DIR)
                and fn != _THIS_FILE and not fn.startswith(_KERNELS_DIR)
                else "")
        if rel:
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "(autograd)"


_SOURCE = {}    # file name -> its path under src/, "" outside the port


class StepCounter(TorchDispatchMode):
    """Count a step's flops, bytes, collectives and ops as it runs.

        with StepCounter(op_log=True) as c:
            step(params, batch)
        c.analyze()        # the dict of `analyze_hlo_text`

    `op_counts` holds the calls of each op name (aten ops by their
    overload, hand-written kernels as ``repro_torch.<LAUNCHES key>``),
    `kernel_calls` the kernels' calls by `cuda_lib.LAUNCHES` key, and
    `peak_bytes` the most storage made during the step and alive at once
    (the step's outputs included while they live)."""

    def __init__(self, *, op_log: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.wire = 0.0
        self.colls = defaultdict(lambda: [0, 0.0])
        self.op_counts = defaultdict(int)
        self.kernel_calls = defaultdict(int)
        self.log = {} if op_log else None
        self.live = 0
        self.peak_bytes = 0
        self._quiet = 0
        self._meta = _MetaCache()
        self._storages = {}
        self._lock = threading.Lock()
        self._prev = []

    # -- entering and leaving -----------------------------------------------

    def __enter__(self):
        self._prev.append(cuda_lib.set_step_counter(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cuda_lib.set_step_counter(self._prev.pop())

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_QUERIES:
            return NotImplemented
        info = _info(func)
        result = None
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op on its local blocks out of this mode's
            # sight: it is counted as that local op (one rank's work)
            result = func(*args, **kwargs)
            args, kwargs, out = _locals((args, kwargs, result))
        else:
            if info.decomposes and func not in _PRIM_DEVICE:
                # an op with a composite decomposition is counted through
                # its parts, as FlopCounterMode counts it
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            if info.cacheable:
                out = self._meta.run(func, args, kwargs)
            else:
                out = func(*args, **kwargs)
        rets = out if len(info.fresh) > 1 else (out,)
        fresh = [t for r, f in zip(rets, info.fresh) if f
                 for t in _tensors(r)]
        self._track(fresh)
        if (self._quiet or info.view or func in _FREE
                or _host_transfer(func, args, out)):
            return out if result is None else result
        ins = _tensors((args, kwargs))
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in fresh)
        rule = flop_registry.get(func._overloadpacket)
        flops = rule(*args, **kwargs, out_val=out) if rule else 0
        if info.collective:
            groups = [tensor_bytes(a) for a in args] + [out_bytes]
            payload = max(groups, default=0)
            g = _process_group_size(args)
            w = _ring_wire_bytes(info.collective, payload, g)
            self.wire += w
            self.colls[info.collective][0] += 1
            self.colls[info.collective][1] += w
            nbytes = in_bytes + payload
        else:
            w = 0.0
            nbytes = in_bytes + out_bytes
        self._add(info.name, flops, nbytes,
                  lambda: tuple(tuple(t.shape) for t in ins), w,
                  info.collective)
        return out if result is None else result

    def _add(self, name, flops, nbytes, shapes, wire=0.0,
             collective=None) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.op_counts[name] += 1
        if self.log is not None:
            key = (name, shapes(), _source_line(), collective)
            row = self.log.get(key)
            if row is None:
                row = self.log[key] = [0, 0, 0, 0.0]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
            row[3] += wire

    # -- storage ------------------------------------------------------------

    def _track(self, tensors) -> None:
        for t in tensors:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            with self._lock:
                self._storages[key] = n
                self.live += n
                self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    # -- hand-written kernels -----------------------------------------------

    def record_kernel(self, key: str, flops: float, nbytes: float,
                      shapes=(), out=()) -> None:
        """One call of the kernel `key` (its `cuda_lib.LAUNCHES` key): the
        flops and bytes of the function it computes, whatever the device
        (a card launch, or shapes alone on ``meta``)."""
        self.kernel_calls[key] += 1
        self._track(_tensors(out))
        self._add(f"repro_torch.{key}", flops, nbytes, lambda: tuple(shapes))

    def quiet(self):
        """A context in which ops run uncounted (a kernel wrapper's own
        bookkeeping: its cached tables, its output allocation); storage is
        still tracked."""
        return _Quiet(self)

    # -- results ------------------------------------------------------------

    def analyze(self) -> dict:
        return {
            "flops": int(self.flops),
            "bytes": float(self.bytes),
            "bytes_unfused": float(self.bytes),
            "wire_bytes": float(self.wire),
            "collectives": {k: {"count": int(c), "bytes": float(b)}
                            for k, (c, b) in sorted(self.colls.items())},
        }

    def op_log(self) -> list:
        """The aggregated op log, by bytes: rows of op, input shapes,
        source, count, flops, bytes, wire bytes and the collective's base
        opcode (None for the rest); empty unless made with
        ``op_log=True``."""
        rows = [{"op": op, "shapes": [list(s) for s in shapes],
                 "source": src, "count": c, "flops": f, "bytes": b,
                 "wire": w, "collective": coll}
                for (op, shapes, src, coll), (c, f, b, w)
                in (self.log or {}).items()]
        rows.sort(key=lambda r: (-r["bytes"], -r["flops"], r["op"]))
        return rows


class _Quiet:
    __slots__ = ("counter",)

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter._quiet += 1

    def __exit__(self, *exc):
        self.counter._quiet -= 1
        return False


def count_step(fn, *args, op_log: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a fresh `StepCounter`;
    returns (its output, the counter)."""
    with StepCounter(op_log=op_log) as counter:
        out = fn(*args, **kwargs)
    return out, counter


def analyze_op_log(rows: list) -> dict:
    """`StepCounter.analyze`'s dict re-derived from a saved op log."""
    colls = defaultdict(lambda: [0, 0.0])
    for r in rows:
        if r.get("collective"):
            colls[r["collective"]][0] += r["count"]
            colls[r["collective"]][1] += r["wire"]
    nbytes = float(sum(r["bytes"] for r in rows))
    return {
        "flops": int(sum(r["flops"] for r in rows)),
        "bytes": nbytes,
        "bytes_unfused": nbytes,
        "wire_bytes": float(sum(r["wire"] for r in rows)),
        "collectives": {k: {"count": int(c), "bytes": float(b)}
                        for k, (c, b) in sorted(colls.items())},
    }
