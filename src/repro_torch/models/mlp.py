"""Dense MLP variants: SwiGLU (llama-family), plain GELU (granite-code),
squared-ReLU (nemotron/minitron)."""
from __future__ import annotations

from .common import ACTS, dense


def init_mlp(gen, cfg) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": dense(gen, D, Fd), "w_up": dense(gen, D, Fd),
                "w_down": dense(gen, Fd, D)}
    return {"w_in": dense(gen, D, Fd), "w_out": dense(gen, Fd, D)}


def mlp_specs(cfg, rules) -> dict:
    """The reference's spec tree of `init_mlp` (no tensors)."""
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": rules.dense_in(D, Fd), "w_up": rules.dense_in(D, Fd),
                "w_down": rules.dense_out(Fd, D)}
    return {"w_in": rules.dense_in(D, Fd), "w_out": rules.dense_out(Fd, D)}


def mlp(p, cfg, x):
    if cfg.mlp_kind == "swiglu":
        return (ACTS["silu"](x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    act = ACTS[cfg.mlp_kind]
    return act(x @ p["w_in"]) @ p["w_out"]
