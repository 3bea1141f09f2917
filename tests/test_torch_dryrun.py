"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* The plan for every arch × shape × mesh: the reference's record without
  XLA's fields, its distribution as the reference's ``lower_cell`` builds it,
  each input's bytes a rank from the port's specs, and the analytic roofline
  equal to the reference's ``analytic_costs`` and ``model_flops`` (on the
  H100's constants). The plan at one card fits exactly the three cells whose
  inputs are far below the card's memory.
* ``--run`` on the CPU at smoke configs: the decode cells that fit, one step
  at their real global shapes; a cell that does not fit is refused before
  anything is allocated; the train and prefill steps of ``run_cell`` at a
  small shape.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json

import numpy as np
import pytest

from repro.launch import roofline as J_R
from repro_torch import configs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MM
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.models.config import SHAPES, ShapeSpec, cell_is_runnable

ONE_CARD = {("mamba2-1.3b", "decode_32k"), ("mamba2-1.3b", "long_500k"), ("hymba-1.5b", "long_500k")}
XLA_FIELDS = ("lower_s", "compile_s", "memory_analysis", "cost_analysis_raw", "collectives", "hlo_bytes")


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_plan")
    recs = DR.main(["--all", "--mesh", "both", "--out", str(out)])
    return out, recs


def test_plan_covers_every_cell(plans):
    out, recs = plans
    assert len(recs) == len(configs.ARCH_NAMES) * len(SHAPES) * 2
    for mk in DR.MESHES:
        for arch in configs.ARCH_NAMES:
            for shape in SHAPES:
                rec = json.loads((out / mk / f"{arch}--{shape}.json").read_text())
                assert rec.get("skipped", False) == (not cell_is_runnable(arch, shape))
                assert not set(XLA_FIELDS) & set(rec)


@pytest.mark.parametrize("mesh_kind", DR.MESHES)
def test_plan_records_equal_the_reference_terms(plans, mesh_kind):
    _, recs = plans
    mesh = MM.make_production_mesh(multi_pod=mesh_kind == "multi")
    for rec in recs:
        if rec.get("skipped") or rec["mesh"] != "x".join(map(str, mesh.shape)):
            continue
        cfg, shape = configs.get_config(rec["arch"]), SHAPES[rec["shape"]]
        assert rec["chips"] == 512 if mesh_kind == "multi" else 256
        ba = ["pod", "data"] if mesh_kind == "multi" else ["data"]
        n_data = 32 if mesh_kind == "multi" else 16
        assert rec["distribution"] == {
            "batch_axes": ba if shape.global_batch % n_data == 0 else [],
            "seq_axes": ["model"] if shape.global_batch % n_data == 0 else ba + ["model"],
            "sp_decode": shape.kind == "decode"}
        want = J_R.analytic_costs(cfg, shape, rec["chips"], microbatches=SP.TRAIN_MICROBATCHES[rec["arch"]],
                                  model_shards=16)
        r = rec["roofline"]
        assert (r["flops_per_chip"], r["hbm_bytes_per_chip"]) == (want["flops_per_chip"], want["hbm_bytes_per_chip"])
        assert r["model_flops_global"] == J_R.model_flops(cfg, shape)
        assert r["t_compute_s"] == want["flops_per_chip"] / R.PEAK_FLOPS
        assert r["t_memory_s"] == want["hbm_bytes_per_chip"] / R.HBM_BW
        assert r["collective_bytes_per_chip"] == 0.0
        specs = SP.input_specs(cfg, shape, mesh)
        assert rec["input_bytes_per_device"] == {
            **{k: SP.per_device_bytes(v) for k, v in specs.items()}, "total": SP.per_device_bytes(specs)}


def test_plan_at_one_card_fits_the_small_decode_cells(plans):
    _, recs = plans
    fits = {(r["arch"], r["shape"]) for r in recs if not r.get("skipped") and r["one_card"]["fits"]}
    assert fits == ONE_CARD
    gemma = DR.fits_one_card("gemma3-4b", "long_500k")
    cache = gemma["input_bytes_per_device"]["cache"]
    assert not gemma["fits"] and cache == 34 * 4 * 524288 * 256 * 2 * 2 + 4


@pytest.mark.parametrize("arch,shape", sorted(ONE_CARD))
def test_run_on_the_cpu_at_smoke_config(tmp_path, arch, shape):
    recs = DR.main(["--run", "--device", "cpu", "--smoke", "--arch", arch, "--shape", shape, "--out", str(tmp_path)])
    assert len(recs) == 1
    rec = json.loads((tmp_path / "run" / f"{arch}--{shape}.json").read_text())
    assert (rec["arch"], rec["shape"], rec["config"], rec["device"]) == (arch, shape, "smoke", "cpu")
    assert rec["finite"] and rec["result_shape"] == [SHAPES[shape].global_batch, configs.get_smoke(arch).vocab_size]
    assert len(rec["step_ms"]) == rec["steps"] == 2 and rec["bound_ms"] > 0
    assert "max_memory_allocated" not in rec  # the host has no device memory to read


def test_run_refuses_a_cell_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit one card"):
        DR.run_record("gemma3-4b", "long_500k", device="cpu")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_run_cell_train_and_prefill_steps(kind):
    cfg = configs.get_smoke("qwen3-8b")
    rec = DR.run_cell(cfg, ShapeSpec("tiny", 16, 2, kind), device="cpu", steps=1, microbatches=2)
    assert rec["finite"] and rec["device"] == "cpu" and len(rec["step_ms"]) == 1
    assert rec["result_shape"] == ([] if kind == "train" else [2, cfg.vocab_size])
    assert np.isfinite(rec["step_ms"][0])
