"""Architecture + shape configuration schema.

Every assigned architecture is a frozen ArchConfig; shapes are the four
assigned (seq_len, global_batch, kind) cells.  `input_specs` gives a
step's batch as (shape, dtype) pairs (the reference's ShapeDtypeStruct
stand-ins for the dry run), and `spec_tensors` makes them tensors, on
``meta`` by default (nothing allocated).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int                   # raw (pre-padding)
    d_head: Optional[int] = None
    mlp_kind: str = "swiglu"     # swiglu | gelu | relu2
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    window: int = 0              # sliding-window attention (0 = full)
    mrope_sections: Optional[tuple] = None   # qwen2-vl (t,h,w) freq shares
    attn_chunk: int = 1024
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_dispatch: str = "global"   # global | local (data-local, see moe.py)
    moe_token_shards: int = 1      # set by the step factory from the mesh
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0          # zamba2: shared attn block period
    slstm_layers: tuple = ()     # xlstm: indices using sLSTM blocks
    # --- enc-dec ---
    enc_layers: int = 0
    enc_seq_div: int = 4         # encoder frames = seq_len // enc_seq_div
    # --- VLM ---
    n_image_tokens: int = 0
    # --- runtime policy ---
    fsdp: bool = False
    tie_embeddings: bool = False
    remat: str = "full"          # full | dots | none
    microbatch: int = 1          # grad-accumulation steps for train_4k
    sub_quadratic: bool = False  # supports long_500k
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        """Exact parameter count (uses the *raw* vocab for MODEL_FLOPS)."""
        D, dh = self.d_model, self.head_dim
        H, KH = self.n_heads, self.n_kv_heads
        n = self.vocab * D                                   # embed
        if not self.tie_embeddings:
            n += self.vocab * D                              # head
        attn = D * H * dh + 2 * D * KH * dh + H * dh * D
        if self.mlp_kind == "swiglu":
            mlp = 3 * D * self.d_ff
        else:
            mlp = 2 * D * self.d_ff
        if self.family == "moe":
            moe = self.n_experts * 3 * D * self.moe_d_ff + D * self.n_experts
            per_layer = attn + moe + 2 * D
            n += self.n_layers * per_layer
        elif self.family == "ssm":  # xlstm
            Di = 2 * D
            m_per = D * 2 * Di + 4 * Di + 3 * Di * Di + Di * 2 * H + Di + Di * D
            s_per = D * 4 * D + H * (D // H) * 4 * (D // H) + D * D + D
            n_s = len(self.slstm_layers)
            n += (self.n_layers - n_s) * (m_per + D) + n_s * (s_per + D)
        elif self.family == "hybrid":
            Di = self.ssm_expand * D
            Hs = Di // self.ssm_headdim
            N = self.ssm_state
            m_per = (D * (2 * Di + 2 * N + Hs) + self.ssm_conv * (Di + 2 * N)
                     + 3 * Hs + Di + Di * D + D)
            n += self.n_layers * m_per
            n_attn_apps = self.n_layers // max(1, self.attn_every)
            n += attn + mlp + 2 * D  # shared attn+mlp block (one copy)
        elif self.family == "encdec":
            enc_per = attn + mlp + 2 * D
            dec_per = 2 * attn + mlp + 3 * D   # self + cross
            n += self.enc_layers * enc_per + self.n_layers * dec_per + D
        else:  # dense / vlm
            per_layer = attn + mlp + 2 * D
            n += self.n_layers * per_layer
        n += D  # final norm
        return n

    def active_param_count(self) -> int:
        """MoE: active params per token (for 6·N_active·D MODEL_FLOPS)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * D * self.moe_d_ff
        moe_active = self.n_layers * self.moe_top_k * 3 * D * self.moe_d_ff
        return full - moe_total + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic (SSM/hybrid) archs (DESIGN.md §6)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# dry-run input specs (shape and dtype only — never allocates)
# ---------------------------------------------------------------------------


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The batch a step of `shape` takes, as `TensorSpec`s under the
    reference's keys: tokens, the VLM's positions and image embeddings,
    the enc-dec's encoder embeddings; decode adds ``cur_len``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16
    D = cfg.d_model
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((B, S), i32)}
        if cfg.family == "vlm":
            specs["positions"] = TensorSpec((B, S, 3), i32)
            specs["image_embeds"] = TensorSpec((B, cfg.n_image_tokens, D),
                                               bf16)
        if cfg.family == "encdec":
            specs["enc_embeds"] = TensorSpec((B, S // cfg.enc_seq_div, D),
                                             bf16)
        return specs
    # decode: one new token against a seq_len-sized state
    specs = {"tokens": TensorSpec((B, 1), i32),
             "cur_len": TensorSpec((), i32)}
    if cfg.family == "vlm":
        specs["positions"] = TensorSpec((B, 1, 3), i32)
    return specs


def spec_tensors(specs: dict, device="meta") -> dict:
    """Empty tensors of `specs`' shapes and dtypes on `device`."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}
