"""The port's joint train step (`sos_tpu_torch.train.joint`) against
`sos_tpu.train.joint.make_joint_train_step` on the CPU, at the tiny
widths of tests/torch_port_fixtures.py, from the same weights and batch.

* both losses within 1e-5 relative of `sos_tpu`'s step's metrics, the
  detector's accuracy the same, and `sos_tpu`'s metric keys;
* the detector's gradients (its BCE on the denoiser's mixed STFT against
  the ground-truth bits) within 1e-4 of each tensor's max |g| of
  `sos_tpu`'s;
* the denoiser's bit for bit the port's own denoiser train step on the
  same weights and batch (its part of the joint step is that step),
  which `test_train_step_matches_sos_tpu` holds, on these weights and
  this batch, to `sos_tpu`'s f32 step (1e-2 relative L2, tensors 5e-2
  of max |g|) and float64 step (stage-2 BiLSTM and heads 1e-4 of max
  |g|);
* both models' new BatchNorm statistics within 1e-6 of `sos_tpu`'s new
  states'; both step counters advance;
* a step that is not finite in one stage (a NaN weight in its head)
  leaves that stage's parameters, Adam state and statistics
  bit-identical while the other applies, and `finite` is 0, as in
  `sos_tpu`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_tpu.data.pipeline import device_mix_and_stft_denoiser as jax_mix_den
from sos_tpu.train import joint as jjoint
from sos_tpu.train import loop as jloop
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax
from sos_tpu_torch.models.layers import batch_norms
from sos_tpu_torch.train import joint, loop as tloop

from tests.test_torch_train import (STEPS_PER_EPOCH, _batch, _max_errors,
                                    _port_grads, _port_state)
from tests.torch_port_fixtures import oracle_variables, tiny_configs

METRIC_KEYS = {"detector_loss", "detector_accuracy", "denoiser_loss",
               "stage1", "stage2", "finite"}


@pytest.fixture(scope="module")
def setup():
    cfg, pcfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=3)
    return cfg, pcfg, det_vars, den_vars


def _port_states(pcfg, det_vars, den_vars):
    (_, det), (_, den) = (
        tloop.init_detector_state(pcfg, "cpu",
                                  state_dict=detector_from_jax(det_vars)),
        tloop.init_denoiser_state(pcfg, "cpu",
                                  state_dict=denoiser_from_jax(den_vars)))
    return det, den


def _jax_joint(cfg, det_vars, den_vars, batch):
    """`sos_tpu`'s joint step: (metrics, new detector state, new denoiser
    state)."""
    det_model, det_state = jloop.init_detector_state(
        cfg, STEPS_PER_EPOCH, variables=det_vars)
    den_model, den_state = jloop.init_denoiser_state(
        cfg, STEPS_PER_EPOCH, variables=den_vars)
    step = jjoint.make_joint_train_step(cfg, det_model, den_model,
                                        STEPS_PER_EPOCH)
    new_det, new_den, metrics = step(
        det_state, den_state, {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()}, new_det, new_den)


def _jax_joint_detector_grads(cfg, det_vars, batch):
    """The detector's gradients in `sos_tpu`'s joint step (the body of
    its `det_loss_fn`), in the port's layout."""
    model, _ = jloop.init_detector_state(cfg, STEPS_PER_EPOCH,
                                         variables=det_vars)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    d = jax_mix_den(jb["clean"], jb["noise"], jb["snr"], jb["bits"],
                    cfg.data, cfg.stft)

    def loss_fn(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": det_vars["batch_stats"]},
            d["mixed"], num_frames=cfg.data.clip_frames, train=True,
            mutable=["batch_stats"])
        return jloop._bce_with_logits(logits, jb["bits"])
    grads = jax.jit(jax.grad(loss_fn))(det_vars["params"])
    return detector_from_jax({"params": jax.tree.map(np.asarray, grads),
                              "batch_stats": det_vars["batch_stats"]})


def _recording_update(monkeypatch):
    """Record each model's gradients as the joint step hands them to
    `guarded_update`, in call order (detector, then denoiser)."""
    seen = []
    real = joint.guarded_update

    def update(state, lr, enabled):
        seen.append({n: p.grad.clone()
                     for n, p in state.model.named_parameters()})
        return real(state, lr, enabled)
    monkeypatch.setattr(joint, "guarded_update", update)
    return seen


def _stats(state, jax_state, convert):
    """The port's running statistics and `sos_tpu`'s new ones."""
    ref = convert({"params": jax.tree.map(np.asarray, jax_state.params),
                   "batch_stats": jax.tree.map(np.asarray,
                                               jax_state.batch_stats)})
    new = state.model.state_dict()
    return [(name, new[name], ref[name]) for name in ref if "running" in name]


def test_joint_step_matches_sos_tpu(setup, monkeypatch):
    cfg, pcfg, det_vars, den_vars = setup
    batch = _batch(11)
    ref_metrics, ref_det, ref_den = _jax_joint(cfg, det_vars, den_vars, batch)
    det, den = _port_states(pcfg, det_vars, den_vars)
    seen = _recording_update(monkeypatch)
    det, den, metrics = joint.make_joint_train_step(pcfg, STEPS_PER_EPOCH)(
        det, den, batch)

    assert set(metrics) == set(ref_metrics) == METRIC_KEYS
    for key in ("detector_loss", "denoiser_loss", "stage1", "stage2"):
        assert abs(metrics[key] - ref_metrics[key]) <= 1e-5 * abs(
            ref_metrics[key]), key
    # the same frames right (of 120; the means round apart)
    assert metrics["detector_accuracy"] == pytest.approx(
        ref_metrics["detector_accuracy"], abs=1e-6)
    assert metrics["finite"] == ref_metrics["finite"] == 1.0
    assert det.step == den.step == 1
    assert tloop.adam_count(det.optimizer) == tloop.adam_count(
        den.optimizer) == 1

    det_grads, den_grads = seen
    errors = _max_errors(det_grads,
                         _jax_joint_detector_grads(cfg, det_vars, batch))
    assert max(errors.values()) <= 1e-4, errors

    state, stage_cfg = _port_state(pcfg, "denoiser", den_vars)
    _, stage_grads = _port_grads(stage_cfg, "denoiser", state, batch)
    assert all(torch.equal(den_grads[n], g) for n, g in stage_grads.items())

    for state, jax_state, convert in ((det, ref_det, detector_from_jax),
                                      (den, ref_den, denoiser_from_jax)):
        stats = _stats(state, jax_state, convert)
        assert stats
        for name, got, want in stats:
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0,
                                       msg=name)


def _snapshot(state):
    opt = {k: {kk: (vv.clone() if torch.is_tensor(vv) else vv)
               for kk, vv in v.items()}
           for k, v in state.optimizer.state_dict()["state"].items()}
    return {k: v.clone() for k, v in state.model.state_dict().items()}, opt


def _bit_identical(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("poisoned", ["detector", "denoiser"])
def test_a_nonfinite_stage_is_skipped_while_the_other_applies(setup,
                                                              poisoned):
    """A NaN in one stage's last bias makes only that stage's loss and
    gradients non-finite (a NaN in the batch would reach both: the bits
    feed the mask of the shared device stage). The poisoned stage's
    weights, Adam moments and count and running statistics stay bit for
    bit, the other stage applies, `finite` is 0 and both step counters
    advance."""
    _, pcfg, det_vars, den_vars = setup
    det, den = _port_states(pcfg, det_vars, den_vars)
    step = joint.make_joint_train_step(pcfg, STEPS_PER_EPOCH)
    det, den, _ = step(det, den, _batch(14))  # moments and a count to keep
    states = {"detector": det, "denoiser": den}
    last = (det.model.fc2 if poisoned == "detector"
            else den.model.context.fc2)
    with torch.no_grad():
        last.bias[0] = float("nan")
    before = {k: _snapshot(s) for k, s in states.items()}
    det, den, metrics = step(det, den, _batch(15))
    assert metrics["finite"] == 0.0
    assert det.step == den.step == 2
    for name, state in states.items():
        weights, opt = before[name]
        after = state.model.state_dict()
        same = all(_bit_identical(after[k], v) for k, v in weights.items())
        if name == poisoned:
            assert same, name
            assert tloop.adam_count(state.optimizer) == 1
            moments = state.optimizer.state_dict()["state"]
            assert all(_bit_identical(moments[k][kk], vv)
                       for k, v in opt.items() for kk, vv in v.items())
            assert all(bn.pending_stats is None
                       for bn in batch_norms(state.model))
        else:
            assert not same, name
            assert tloop.adam_count(state.optimizer) == 2
    loss = metrics[f"{poisoned}_loss"]
    other = metrics[("denoiser" if poisoned == "detector" else "detector")
                    + "_loss"]
    assert not np.isfinite(loss) and np.isfinite(other)


def test_init_joint_states_seeds_each_stage(setup):
    """The detector from `seed`, the denoiser from `seed + 1`, as
    `init_*_state(seed=...)` draws them."""
    _, pcfg, _, _ = setup
    (_, det), (_, den) = joint.init_joint_states(pcfg, "cpu", seed=5)
    (_, det5) = tloop.init_detector_state(pcfg, "cpu", seed=5)
    (_, den6) = tloop.init_denoiser_state(pcfg, "cpu", seed=6)
    for got, want in ((det, det5), (den, den6)):
        for (n, a), b in zip(got.model.state_dict().items(),
                             want.model.state_dict().values()):
            assert torch.equal(a, b), n
    assert not torch.equal(det.model.fc2.weight,
                           tloop.init_detector_state(pcfg, "cpu", seed=6)[1]
                           .model.fc2.weight)
