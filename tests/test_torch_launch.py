"""The port's checkpoints, FT supervisor, host mesh and training launcher.

Checkpoints are held to the reference's format byte for byte in both
directions: each package restores the other's checkpoint of a reduced
model's params and AdamW state bit for bit, and the two packages' saves of
the same tree have the same files (names and bytes, manifest included).
The launcher's resumed run on the CPU equals the uninterrupted one bit for
bit (losses and gradient norms), from the same checkpoint.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as rck
from repro.configs import registry as rreg
from repro.dist.sharding import ShardingRules
from repro.models import transformer as rt
from repro.optim import adamw as radam
from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.launch.ft import FTConfig, Supervisor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw as tadam

RULES = ShardingRules(model_size=1, data_size=1, fsdp=False)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _bits(x) -> np.ndarray:
    """The leaf's bytes as unsigned integers, from either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return np.ascontiguousarray(x.numpy()).view(
            f"u{x.element_size()}" if x.dtype != torch.bool else "u1")
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _assert_bit_equal(got: dict, want: dict):
    fg, fw = _flat(got), _flat(want)
    assert list(fg) == list(fw)
    for k in fw:
        assert (str(fg[k].dtype).split(".")[-1]
                == str(fw[k].dtype).split(".")[-1]), k
        np.testing.assert_array_equal(_bits(fg[k]), _bits(fw[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 2
    restored, manifest = restore_checkpoint(str(tmp_path), 4, tree,
                                            device="cpu")
    assert manifest["step"] == 4
    _assert_bit_equal(restored, tree)
    # the async writer: files are there once the thread is joined
    t = save_checkpoint(str(tmp_path), 5, tree, keep=2, blocking=False,
                        extra_meta={"note": "x"})
    t.join(timeout=60)
    assert not t.is_alive()
    assert latest_step(str(tmp_path)) == 5
    assert restore_checkpoint(str(tmp_path), 5, tree,
                              device="cpu")[1]["note"] == "x"
    assert latest_step(str(tmp_path / "missing")) is None


def _reference_state(name):
    """A reduced model's bf16 params and its AdamW state after one update
    (so m and v are not zero), from the reference."""
    cfg = rreg.reduced_config(rreg.get_arch(name))
    params, _ = rt.init_model(jax.random.PRNGKey(0), cfg, RULES)
    opt = radam.init_opt_state(params)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    params, opt, _ = radam.adamw_update(radam.AdamWConfig(), grads, opt,
                                        params)
    return params, opt


def _port_like(tree):
    """The reference's tree as the port holds it, bit for bit."""
    out = {k: v for k, v in tree.items() if k != "step"}
    conv = lm_params_from_numpy(jax.tree.map(np.asarray, out),
                                device="cpu")
    if "step" in tree:
        conv["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32)
    return conv


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", ["qwen3-4b", "zamba2-1.2b", "xlstm-125m"])
def test_checkpoints_cross_between_packages(tmp_path, name):
    rparams, ropt = _reference_state(name)
    tparams, topt = _port_like(rparams), _port_like(ropt)
    meta = {"pipeline": {"phase": 1, "step_in_phase": 2}}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    for d, save, p, o in ((ref_dir, rck.save_checkpoint, rparams, ropt),
                          (port_dir, save_checkpoint, tparams, topt)):
        save(d, 3, p, extra_meta=meta)
        save(d + "/opt", 3, o, extra_meta=meta)
    for sub in ("", "/opt"):
        rf = _files(os.path.join(ref_dir + sub, "step_00000003"))
        pf = _files(os.path.join(port_dir + sub, "step_00000003"))
        assert list(pf) == list(rf)
        assert pf == rf                   # every file, manifest included

    # the port restores the reference's checkpoint ...
    like_p = _port_like(jax.tree.map(jnp.zeros_like, rparams))
    got_p, man = restore_checkpoint(ref_dir, 3, like_p, device="cpu")
    got_o, _ = restore_checkpoint(ref_dir + "/opt", 3,
                                  tadam.init_opt_state(like_p),
                                  device="cpu")
    assert man["pipeline"] == meta["pipeline"]
    _assert_bit_equal(got_p, tparams)
    _assert_bit_equal(got_o, topt)
    # ... and the reference the port's
    want_p, _ = rck.restore_checkpoint(port_dir, 3, rparams)
    want_o, _ = rck.restore_checkpoint(port_dir + "/opt", 3, ropt)
    _assert_bit_equal(want_p, rparams)
    _assert_bit_equal(want_o, ropt)


# ---------------------------------------------------------------------------
# FT supervisor: a twin of the reference's test
# ---------------------------------------------------------------------------


def test_supervisor_detects_straggler_and_deadline():
    sup = Supervisor(4, FTConfig(straggler_factor=2.0, patience=2,
                                 deadline_s=10.0))
    t = 1000.0
    for step in range(5):
        t += 1
        for w in range(3):
            sup.heartbeat(w, 1.0, now=t)
        sup.heartbeat(3, 5.0, now=t)  # persistent straggler
        sup.check(now=t)
    assert (3, "straggler") in sup.events
    assert sup.healthy_count() == 3
    # deadline: worker 2 stops beating
    for step in range(3):
        t += 20
        for w in (0, 1):
            sup.heartbeat(w, 1.0, now=t)
        sup.check(now=t)
    assert any(w == 2 and r == "deadline" for w, r in sup.events)
    # elastic downsizing proposes a power-of-two data axis
    assert sup.elastic_data_axis(model_size=4, chips_per_host=4) in (1, 2)


# ---------------------------------------------------------------------------
# mesh and launcher
# ---------------------------------------------------------------------------


def test_host_mesh_takes_only_the_devices_there_are():
    mesh = make_host_mesh(1, 1, device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.device.type, mesh.size) == (
        ("data", "model"), (1, 1), "cpu", 1)
    for data, model in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="mesh needs"):
            make_host_mesh(data, model, device="cpu")


def test_launcher_resumes_bit_for_bit(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--arch", "qwen3-4b", "--steps", "6", "--ckpt-every", "3",
            "--ckpt-dir", d, "--device", "cpu"]
    full = launch_train.main(argv)
    assert [h["step"] for h in full] == list(range(6))
    assert all(np.isfinite(h["loss"]) for h in full)
    assert latest_step(d) == latest_step(d + "/opt") == 6
    # cut the run back to its step-3 checkpoint, then resume
    for sub in ("", "/opt"):
        shutil.rmtree(os.path.join(d + sub, "step_00000006"))
    resumed = launch_train.main(argv + ["--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [3, 4, 5]
    for a, b in zip(full[3:], resumed):
        assert (a["loss"], a["grad_norm"], a["lr"]) == (
            b["loss"], b["grad_norm"], b["lr"])
    with pytest.raises(ValueError, match="mesh needs"):
        launch_train.main(argv + ["--data", "2"])
