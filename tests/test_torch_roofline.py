"""The port's roofline terms (``repro_torch.launch.roofline``) against the
JAX package's: ``tests/test_roofline.py`` mirrored on the port (its
constants are the H100's), and ``analytic_costs`` and ``model_flops`` equal
to the reference's for every arch × shape."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses

import pytest

from repro import configs as J_configs
from repro.launch import roofline as J_R
from repro.models.config import SHAPES as J_SHAPES
from repro_torch import configs
from repro_torch.launch import roofline as R
from repro_torch.models.config import SHAPES


def test_shape_bytes():
    assert R.shape_bytes("f32[16,512,9496]{2,1,0}") == 16 * 512 * 9496 * 4
    assert R.shape_bytes("bf16[8]{0}") == 16
    assert R.shape_bytes("(f32[2,2]{1,0}, bf16[4]{0})") == 16 + 8
    assert R.shape_bytes("pred[]") == 1  # scalar: one element
    assert R.shape_bytes("no shapes here") == 0


HLO = """\
HloModule test, entry_computation_layout={()->f32[]}

%wide.body (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ar = f32[4]{0} all-reduce(%x), to_apply=%add
  ROOT %t = tuple(%i, %ar)
}

%wide.cond (p: (s32[], f32[4])) -> pred[] {
  %c = s32[] constant(7)
  ROOT %cmp = pred[] compare(%i, %c), direction=LT
}

ENTRY %main (a: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]) while(%init), condition=%wide.cond, body=%wide.body
  %ag = f32[8]{0} all-gather(%y), dimensions={0}
  ROOT %out = f32[4]{0} get-tuple-element(%w), index=1
}
"""


def test_collective_bytes_weights_loops():
    got = R.collective_bytes(HLO)
    assert got["all-reduce"] == 7 * 16  # 7 trips × f32[4]
    assert got["all-gather"] == 32
    assert got["total"] == 7 * 16 + 32
    assert got == J_R.collective_bytes(HLO)


def test_trip_count_parse():
    comps = R._split_computations(HLO)
    assert "wide.cond" in comps and "wide.body" in comps and "main" in comps
    assert R._trip_count(comps["wide.cond"]) == 7
    assert comps == J_R._split_computations(HLO)


def test_h100_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_terms_and_bottleneck():
    r = R.Roofline(
        flops_per_chip=R.PEAK_FLOPS, hbm_bytes_per_chip=R.HBM_BW / 2,
        collective_bytes_per_chip=R.LINK_BW / 4, chips=256, model_flops_global=R.PEAK_FLOPS * 256 * 0.5,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.mfu_upper_bound == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.to_dict()["t_compute_s"] == pytest.approx(1.0) and r.step_time_lower_bound == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b", "mamba2-1.3b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_analytic_costs_positive_and_ordered(arch, shape):
    cfg = configs.get_config(arch)
    c = R.analytic_costs(cfg, SHAPES[shape], 256, microbatches=4, model_shards=16)
    assert c["flops_per_chip"] > 0 and c["hbm_bytes_per_chip"] > 0
    # Training must cost more FLOPs than prefill which costs more than decode.
    if shape == "train_4k":
        pre = R.analytic_costs(cfg, SHAPES["prefill_32k"], 256, model_shards=16)
        dec = R.analytic_costs(cfg, SHAPES["decode_32k"], 256, model_shards=16)
        assert c["flops_per_chip"] > pre["flops_per_chip"] > dec["flops_per_chip"]


def test_model_flops_moe_uses_active_params():
    moe = configs.get_config("deepseek-moe-16b")
    dense_equiv = R.model_flops(moe, SHAPES["train_4k"])
    assert dense_equiv < 6 * moe.param_count() * SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_analytic_costs_and_model_flops_equal_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), J_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for chips, model_shards, mb in ((256, 16, 1), (512, 16, 4), (1, 1, 1), (8, 4, 2)):
        got = R.analytic_costs(cfg, SHAPES[shape], chips, microbatches=mb, model_shards=model_shards)
        assert got == J_R.analytic_costs(jcfg, J_SHAPES[shape], chips, microbatches=mb, model_shards=model_shards)
    assert R.model_flops(cfg, SHAPES[shape]) == J_R.model_flops(jcfg, J_SHAPES[shape])
    assert R._attn_context(cfg, SHAPES[shape].seq_len) == J_R._attn_context(jcfg, J_SHAPES[shape].seq_len)
