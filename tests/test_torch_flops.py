"""The port's FLOP count (cropnerf_tpu_torch/utils/flops.py) against the
JAX package's: the counts of every preset equal, the counting functions
the JAX file's code (syntax trees without docstrings), ``mfu`` and
``speed_of_light`` the same arithmetic on a peak and ceilings the caller
gives, and no figure of another chip kept in the port's module."""
from __future__ import annotations

import dataclasses

import pytest

from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.utils import flops as jflops
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.utils import flops
from test_torch_copies import REPO, _top_level

COPIED = ["_POS_FREQS", "_DIR_FREQS", "_mlp_dims", "_mlp_flops",
          "field_flops_per_sample", "prop_flops_per_sample",
          "train_step_flops", "_table_rows_per_step"]


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_counts_equal_jax(preset):
    jcfg, cfg = JAX_PRESETS[preset], PRESETS[preset]
    assert flops.train_step_flops(cfg) == jflops.train_step_flops(jcfg)
    assert (flops.field_flops_per_sample(cfg.model.field)
            == jflops.field_flops_per_sample(jcfg.model.field) > 0)
    assert [flops.prop_flops_per_sample(p)
            for p in cfg.model.proposal_fields] == [
        jflops.prop_flops_per_sample(p) for p in jcfg.model.proposal_fields]
    # the schedule's amortised proposal backward and the remat switch
    for change in (dict(proposal_no_grad_schedule=False), dict(remat=True)):
        assert flops.train_step_flops(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **change))) == \
            jflops.train_step_flops(dataclasses.replace(
                jcfg, model=dataclasses.replace(jcfg.model, **change)))


@pytest.mark.parametrize("name", COPIED)
def test_counting_holds_the_jax_code(name):
    rel = "utils/flops.py"
    assert (_top_level(REPO / "cropnerf_tpu_torch" / rel)[name]
            == _top_level(REPO / "cropnerf_tpu" / rel)[name])


def test_remat_adds_no_model_flops():
    cfg = PRESETS["cropnerf-big"]
    assert cfg.model.remat
    off = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=False))
    assert flops.train_step_flops(cfg) == flops.train_step_flops(off)


def test_mfu_needs_a_peak():
    with pytest.raises(TypeError):
        flops.mfu(1e12, 1.0)
    for peak in (None, 0.0, -1.0):
        with pytest.raises(ValueError, match="peak"):
            flops.mfu(1e12, 1.0, peak)
    got = flops.mfu(3e12, 0.5, 989.0)
    ref = jflops.mfu(3e12, 0.5, 989.0)
    assert got == {"tflops_per_s": ref["tflops_per_s"],
                   "mfu": ref["mfu_vs_measured_peak"]}
    assert got["tflops_per_s"] == pytest.approx(6.0)


@pytest.mark.parametrize("preset", ["cropnerf", "cropnerf-mxu",
                                    "cropnerf-mxu-q", "cropnerf-huge"])
def test_speed_of_light_on_given_ceilings(preset):
    ceilings = {"square4096": 500.0, "trunk256": 300.0, "prop128": 80.0,
                "prop64": 60.0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflops, "SHAPE_CEILINGS_TFLOPS", ceilings)
        ref = jflops.speed_of_light(JAX_PRESETS[preset])
    assert flops.speed_of_light(PRESETS[preset], ceilings) == ref
    assert ref["sol_ms"] > 0


def test_no_other_chip_figure():
    assert not hasattr(flops, "MEASURED_BF16_PEAK_TFLOPS")
    assert not hasattr(flops, "SHAPE_CEILINGS_TFLOPS")
    with pytest.raises(TypeError):
        flops.speed_of_light(PRESETS["cropnerf"])
