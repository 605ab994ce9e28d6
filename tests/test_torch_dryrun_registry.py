"""Every published config's prefill and decode cells of the registry,
counted by the port's dry run on ``meta`` tensors at full width, depth and
shape: no card and no memory.  (Its own file, so that test workers that
take whole files share the time: xlstm's prefill_32k alone counts 65,536
sLSTM steps, ~2 minutes.)"""
import pytest

from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun

ARCHS = list(treg.ARCHS)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
def test_full_registry_serving_cells_on_meta(shape, tmp_path):
    """Each cell is ok, or skipped where `shape_applicable` says; a
    prefill counts one flash call a self-attention layer."""
    for arch in ARCHS:
        cfg = treg.get_arch(arch)
        rec = dryrun.dryrun_cell(arch, shape, out_dir=str(tmp_path),
                                 verbose=False)
        if not tbase.shape_applicable(cfg, tbase.SHAPES[shape]):
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok", arch
        assert rec["device"] == "meta"
        flash = rec["kernel_calls"].get("flash_attention_tc", 0)
        if tbase.SHAPES[shape].kind == "prefill":
            attn = cfg.n_layers // cfg.attn_every \
                if cfg.family == "hybrid" else cfg.n_layers + cfg.enc_layers
            assert flash == (0 if cfg.family == "ssm" else attn), arch
        else:
            assert flash == 0
        # model flops count every parameter; the counted products miss
        # xLSTM's gates and norms (ratio 1.11 / 1.21) and add the rest's
        # masked attention halves and padded vocab
        assert 0.5 < rec["useful_flops_ratio"] < 1.5, arch
