"""Logical-axis sharding rules for the production mesh.

One frozen ``ShardingRules`` instance maps every logical parameter /
activation axis to a partition spec (`P`, a tuple of mesh axis names)
over the mesh axes ``("data", "model")`` (plus an outer ``"pod"`` axis on
multi-pod meshes):

* tensor parallel — feature/head output dims shard on ``"model"``
  (megatron column/row split: ``dense_in`` shards the output dim,
  ``dense_out`` shards the reduction dim);
* FSDP — with ``fsdp=True`` the *other* weight dim additionally shards
  on ``"data"`` (ZeRO-3: the optimizer state inherits the same specs);
* data parallel — batch dims shard on ``"data"`` (and ``"pod"``).

Divisibility policy: a dim that does not divide its mesh axis falls back
to replicated (``None``) — GSPMD would pad, which silently wastes memory,
so we never emit a non-divisible spec.  Head counts are the exception:
attention correctness couples the head axis to the model axis, so a head
count that neither divides nor is divided by ``model_size`` (no clean
TP split *and* no clean replication group) raises ``ValueError``.

On a torch `DeviceMesh` a spec becomes one DTensor placement a mesh
dimension (`placements`): ``Shard(d)`` on each mesh axis that tensor dim
`d` names, ``Replicate()`` elsewhere.  A tuple entry such as ``("pod",
"data")`` shards its dim over both axes, the outer one first (JAX's
major-to-minor order), so the axes of a tuple must come in the mesh's
order.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.tensor import Replicate, Shard


class P(tuple):
    """A partition spec: one entry per array axis, each a mesh axis name, a
    tuple of names, or None (replicated).  A plain tuple of its entries, so
    it compares equal to any spec with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh-shape-aware spec factory.

    model_size / data_size — sizes of the "model" / "data" mesh axes.
    fsdp      — additionally shard weight reduction dims on "data".
    multi_pod — an outer "pod" axis (size 2 in production) exists; batch
                dims shard on ("pod", "data") and cross-pod gradient
                traffic is handled by optim.compress.
    """
    model_size: int
    data_size: int
    fsdp: bool = False
    multi_pod: bool = False
    pod_size: int = 2

    def __post_init__(self):
        if self.model_size < 1 or self.data_size < 1:
            raise ValueError(
                f"mesh axis sizes must be >= 1, got model={self.model_size} "
                f"data={self.data_size}")

    # -- axis helpers -----------------------------------------------------

    @property
    def fsdp_ax(self):
        return "data" if self.fsdp else None

    def _model(self, dim: int):
        """"model" iff the dim splits evenly; replicated otherwise."""
        if self.model_size > 1 and dim % self.model_size == 0:
            return "model"
        return None

    def _fsdp(self, dim: int):
        if self.fsdp and dim % self.data_size == 0:
            return "data"
        return None

    def _heads(self, n_heads: int):
        """Head dims must split evenly or replicate as a whole group."""
        if self.model_size <= 1 or n_heads % self.model_size == 0:
            return self._model(n_heads)
        if self.model_size % n_heads == 0:
            return None  # fewer (kv) heads than model shards: replicate
        raise ValueError(
            f"n_heads={n_heads} incompatible with model_size="
            f"{self.model_size}: neither divides the other")

    def batch_ax(self, batch: int):
        """Mesh axes for a leading batch dim (None when not divisible)."""
        if self.multi_pod and batch % (self.pod_size * self.data_size) == 0:
            return ("pod", "data")
        if batch % self.data_size == 0:
            return "data"
        return None

    # -- parameters -------------------------------------------------------

    def vector(self) -> P:
        """1-D norm/bias/gate weights: tiny, replicated."""
        return P(None)

    def embed(self, vocab: int, d_model: int) -> P:
        """(V, D) embedding: vocab on model, d_model FSDP-sharded."""
        return P(self._model(vocab), self._fsdp(d_model))

    def dense_in(self, d_in: int, d_out: int) -> P:
        """(d_in, d_out) column-parallel projection (output dim on model)."""
        return P(self._fsdp(d_in), self._model(d_out))

    def dense_in_heads(self, d_in: int, n_heads: int, d_out: int) -> P:
        """(d_in, H*dh) q/k/v projection: split by whole heads only."""
        return P(self._fsdp(d_in), self._heads(n_heads))

    def dense_out(self, d_in: int, d_out: int) -> P:
        """(d_in, d_out) row-parallel projection (reduction dim on model)."""
        return P(self._model(d_in), self._fsdp(d_out))

    def expert_in(self, n_experts: int, d_model: int, d_ff: int) -> P:
        """(E, D, F) expert up/gate: F on model, D FSDP (E stays local —
        every shard holds all experts; dispatch is token-sharded)."""
        return P(None, self._fsdp(d_model), self._model(d_ff))

    def expert_out(self, n_experts: int, d_ff: int, d_model: int) -> P:
        """(E, F, D) expert down: F (reduction) on model, D FSDP."""
        return P(None, self._model(d_ff), self._fsdp(d_model))

    # -- decode-state / activation specs ---------------------------------

    def kv_cache(self, batch: int, n_kv_heads: int) -> P:
        """(B, KH, S, dh) cache: batch on data, kv heads on model."""
        return P(self.batch_ax(batch), self._heads(n_kv_heads), None, None)

    def ssm_state(self, batch: int, n_heads: int) -> tuple:
        """(B, H, N, P) mamba2 state axes (callers prepend a layer dim)."""
        return (self.batch_ax(batch), self._heads(n_heads), None, None)

    def mlstm_state(self, batch: int, n_heads: int, dk: int) -> tuple:
        """(B, H, dk, dv+1) mLSTM matrix-memory axes."""
        return (self.batch_ax(batch), self._heads(n_heads), None, None)

    def act_hidden(self, batch: int) -> P:
        """(B, S, D) residual-stream activations."""
        return P(self.batch_ax(batch), None, None)

    def act_logits(self, batch: int, vocab: int) -> P:
        """(B, S, V) logits: vocab on model (padded vocab divides)."""
        return P(self.batch_ax(batch), None, self._model(vocab))

    def tokens(self, batch: int) -> P:
        """(B, S) int32 token ids."""
        return P(self.batch_ax(batch), None)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------


def placements(mesh, spec) -> tuple:
    """The DTensor placements of `spec` on `mesh`: one a mesh dimension."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of {entry} must come in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} named "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)
