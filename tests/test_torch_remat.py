"""Rematerialisation in the port (``ModelConfig.remat`` and
``remat_props``, models/model.py ``_remat``): the training step of
cropnerf-tiny with ``remat`` on against the JAX package's, also with
``remat`` on (``jax.checkpoint``), at tests/test_torch_hash_model.py's
float32-arm tolerance (1e-3 of each leaf's largest value); remat on, and
``remat_props`` alone, against remat off on the port, for the hash field
and a reduced semantic-nerf (the gradients bit for bit on the CPU); that
remat stores less (the bytes the forward packs for the backward), replays
the checkpointed functions in the backward and not on a frozen-proposal
step or in the BayesRays pass, and draws no random number in a replay."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cropnerf_tpu_torch.models import model as tmodel
from cropnerf_tpu_torch.train import step as tstep
from cropnerf_tpu_torch.uncertainty.bayesrays import ComputeUncertainty
from test_torch_hash_model import (  # noqa: F401 (f32: a fixture)
    FROZEN_STEP, UPDATE_STEP, _cfgs, _params, _small, f32)
from test_torch_train import (PIXEL_SEED, RAYS, _banks, _close,
                              _jax_loss_fn, _jax_rays, _named)
from torch_parity import ray_arrays, torch_bundle

MODES = {"off": dict(remat=False, remat_props=False),
         "remat": dict(remat=True, remat_props=False),
         "remat_props": dict(remat=False, remat_props=True)}


def _port_cfg(name: str, mode: str):
    """The port's ``name`` preset (semantic-nerf cut to small tables and
    few samples) with rematerialisation set by ``mode``."""
    cfg = _cfgs(name, train_num_rays_per_batch=RAYS)[1]
    if name != "cropnerf-tiny":
        cfg = _small(cfg)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **MODES[mode]))


def _step(cfg, step=UPDATE_STEP):
    """One training step's loss, metrics and gradients by name on the
    seeded parameters (cropnerf-tiny: the JAX init's copy)."""
    tp = _port_params(cfg)
    _, tb = _banks()
    idx = np.random.default_rng(PIXEL_SEED).integers(0, tb.num_pixels, (RAYS,))
    loss, aux = tstep.train_loss(tp, tb, torch.from_numpy(idx), step, cfg,
                                 torch.Generator().manual_seed(5))
    loss.backward()
    grads = {k: p.grad for k, p in tp.named_parameters()
             if p.grad is not None}
    return loss, aux, grads


def _port_params(cfg):
    if cfg.model.field.field_type == "hash":
        return _params("cropnerf-tiny")[1]
    return tmodel.model_init(cfg.model, 4, torch.Generator().manual_seed(0),
                             device="cpu")


def test_remat_train_step_matches_jax(f32):
    """cropnerf-tiny with remat on in both packages: loss, terms and every
    gradient leaf in the float32 arm.  Both run the proposal nets
    unconditionally, as test_torch_hash_model's step test does."""
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, remat=True, proposal_no_grad_schedule=False))
        for c in _cfgs("cropnerf-tiny", train_num_rays_per_batch=RAYS))
    params, tp = _params("cropnerf-tiny")
    jb, tb = _banks()
    idx = np.random.default_rng(PIXEL_SEED).integers(0, jb.num_pixels, (RAYS,))
    jidx = jnp.asarray(idx, jnp.int32)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss_fn(jcfg, jb, jidx, UPDATE_STEP)(
            p, *_jax_rays(jb, jidx)), has_aux=True))(params)
    t_loss, t_aux = tstep.train_loss(tp, tb, torch.from_numpy(idx),
                                     UPDATE_STEP, tcfg,
                                     compute_dtype=f32.dtype)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-4,
                               atol=1e-4)
    for k, v in aux.items():
        np.testing.assert_allclose(t_aux[k].item(), float(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    got = {k: p.grad.numpy() for k, p in tp.named_parameters()}
    ref = _named(grads)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.abs(r).sum() > 0, k
        _close(got[k], r, f32, k)


@pytest.mark.parametrize("mode", ["remat", "remat_props"])
@pytest.mark.parametrize("name", ["cropnerf-tiny", "semantic-nerf"])
def test_remat_gradients_equal_remat_off(name, mode):
    loss_off, aux_off, off = _step(_port_cfg(name, "off"))
    loss_on, aux_on, on = _step(_port_cfg(name, mode))
    assert torch.equal(loss_on, loss_off)
    assert set(on) == set(off) and len(off) > 0
    for k in off:
        assert torch.equal(on[k], off[k]), k
    for k in aux_off:
        assert torch.equal(aux_on[k], aux_off[k]), k


def _saved_bytes(cfg) -> int:
    """Bytes the forward of one training step packs for its backward."""
    tp = _port_params(cfg)
    _, tb = _banks()
    idx = torch.from_numpy(np.random.default_rng(PIXEL_SEED).integers(
        0, tb.num_pixels, (RAYS,)))
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tstep.train_loss(tp, tb, idx, UPDATE_STEP, cfg,
                                   torch.Generator().manual_seed(5))
    loss.backward()
    return total[0]


@pytest.mark.parametrize("name", ["cropnerf-tiny", "semantic-nerf"])
def test_remat_stores_less(name):
    """Remat is no no-op: the proposal nets' residuals leave the graph
    with remat_props, and the field's too with remat."""
    off, props, full = (_saved_bytes(_port_cfg(name, mode))
                        for mode in ("off", "remat_props", "remat"))
    assert full < props < off, (full, props, off)


def _counting(monkeypatch):
    """Calls of the two checkpointed functions, by name."""
    calls = {"proposal_density": 0, "field_all": 0}
    for name in calls:
        fn = getattr(tmodel, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tmodel, name, counted)
    return calls


@pytest.mark.parametrize("mode, step, want", [
    ("off", UPDATE_STEP, (1, 1)),
    ("remat", UPDATE_STEP, (2, 2)),
    ("remat_props", UPDATE_STEP, (2, 1)),
    # off the proposal schedule the proposal nets record no graph, so they
    # are neither checkpointed nor replayed
    ("remat", FROZEN_STEP, (1, 2)),
    ("remat_props", FROZEN_STEP, (1, 1))])
def test_replays_per_step(monkeypatch, mode, step, want):
    """Calls of each proposal net and of the field in one step: the
    forward's, plus the backward's replay where checkpointed."""
    cfg = _port_cfg("cropnerf-tiny", mode)
    assert bool(tstep._prop_update_bool(step, cfg)) == (step == UPDATE_STEP)
    calls = _counting(monkeypatch)
    _step(cfg, step)
    n_prop = cfg.model.num_proposal_iterations
    assert (calls["proposal_density"], calls["field_all"]) == (
        want[0] * n_prop, want[1])


def test_bayesrays_pass_replays_nothing(monkeypatch):
    """The Hessian pass samples without a graph and differentiates
    field_density, outside the checkpointed functions: with remat on it
    calls each once and gives remat off's grid bit for bit."""
    grids = {}
    for mode in ("off", "remat"):
        cfg = _port_cfg("cropnerf-tiny", mode).model
        calls = _counting(monkeypatch)
        grids[mode] = ComputeUncertainty(_params("cropnerf-tiny")[1], cfg,
                                         lod=3).batch(
            torch_bundle(ray_arrays(16)))
        assert calls == {"proposal_density": cfg.num_proposal_iterations,
                         "field_all": 0}, (mode, calls)
    assert torch.equal(grids["remat"], grids["off"])
    assert grids["off"].abs().sum() > 0


class _SeededOps(TorchDispatchMode):
    """Every operator run under it, and those that draw random numbers
    (the ``nondeterministic_seeded`` tag)."""

    def __init__(self):
        super().__init__()
        self.ops, self.seeded = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if torch.Tag.nondeterministic_seeded in func.tags:
            self.seeded.append(str(func))
        return func(*args, **(kwargs or {}))


def _backward_ops(cfg, monkeypatch, draw_inside: bool) -> _SeededOps:
    if draw_inside:           # a random draw moved into a checkpointed net
        density = tmodel.proposal_density

        def drawing(prop, positions, *args, **kwargs):
            jitter = 1e-6 * torch.rand(positions.shape)
            return density(prop, positions + jitter, *args, **kwargs)

        monkeypatch.setattr(tmodel, "proposal_density", drawing)
    tp = _port_params(cfg)
    _, tb = _banks()
    idx = torch.from_numpy(np.random.default_rng(PIXEL_SEED).integers(
        0, tb.num_pixels, (RAYS,)))
    loss, _ = tstep.train_loss(tp, tb, idx, UPDATE_STEP, cfg,
                               torch.Generator().manual_seed(5))
    mode = _SeededOps()
    with mode:
        loss.backward()
    return mode


@pytest.mark.parametrize("draw_inside", [False, True],
                         ids=["model", "draw-moved-inside"])
def test_replay_draws_no_random_number(monkeypatch, draw_inside):
    """The checkpoint stashes no RNG state (preserve_rng_state=False), so a
    draw inside a checkpointed function would replay other numbers: the
    backward, replays included, runs no seeded operator.  The second case
    moves a draw inside to show the check sees one."""
    off = _backward_ops(_port_cfg("cropnerf-tiny", "off"), monkeypatch,
                        False)
    on = _backward_ops(_port_cfg("cropnerf-tiny", "remat"), monkeypatch,
                       draw_inside)
    assert on.ops > off.ops            # the replays ran in the backward
    assert off.seeded == []
    assert bool(on.seeded) == draw_inside, on.seeded
