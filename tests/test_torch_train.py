"""The port's train steps against `sos_tpu`'s on the CPU, at the tiny
widths of tests/torch_port_fixtures.py, from the same weights and batch.

* loss within 1e-5 relative of `sos_tpu`'s f32 step; the new
  BatchNorm running statistics within 1e-6;
* the detector's gradients within 1e-4 of each tensor's max |g| of
  `sos_tpu`'s (fp32 sums in another order through a deep network);
* the denoiser's: its f32 gradient is discontinuous at the ReLU/PReLU
  kinks, and the gated STFT (a third of it exact zeros) feeds whole
  constant regions that sit near one, so two correct fp32 evaluations
  differ there. Over batch seeds 11-18 the port's against `sos_tpu`'s
  f32 gradients differed by 5e-6 to 3.2e-3 in relative L2 over all
  parameters, by up to 1.8e-2 of a tensor's max |g| (PReLU slopes,
  single cancelling sums, up to 0.44). So the InpaintNet's gradients of
  the stage-1 loss are held within 1e-4 of max |g| against `sos_tpu`'s
  evaluated in float64 (`jax.enable_x64`); the full step's stage-2
  BiLSTM and heads within 1e-4 of max |g| against `sos_tpu`'s float64
  step, and all its gradients within 1e-2 relative L2 of that step and
  of `sos_tpu`'s f32 one, and 5e-2 of each tensor's max |g| of the f32
  one (tensors, not the scalar slopes). The float64 gradient itself
  moves by over 1e-3 of a trunk tensor's max |g| under 1e-7 relative
  input noise (`test_denoiser_exact_gradient_moves_under_input_rounding`);
* Adam (`torch.optim.Adam`) against `optax.adam` fed the same gradients
  (`sos_tpu`'s, converted) for 3 steps: parameters within 1e-7 plus
  4e-7 relative. The two round the moments and bias corrections in
  another order, so each step's `p + u` may round one fp32 ulp apart:
  3 ulps of |p| after 3 steps (measured: 1.8e-7 at |p| = 0.50);
* remat on and off give the same step, with the BatchNorm statistics
  applied once;
* a non-finite batch leaves parameters, Adam moments and count and the
  running statistics bit-identical, with `finite` 0;
* the lr staircase follows the optimizer's own count after a skip;
* bf16 (`compute_dtype="bfloat16"`), remat on and off: the loss and the
  gradients within the distance bf16 moves `sos_tpu`'s own step from
  its f32 step on the same weights and batch (relative loss gap,
  relative L2 of all gradients), measured in the same run. `sos_tpu`'s
  bf16 step runs with XLA's excess precision off (`STRICT_BF16`): by
  default XLA's CPU compiler keeps a bf16 conv's f32 result into the
  BatchNorm after it, where cuDNN's bf16 conv, and so the port, rounds
  it to bf16 first.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sos_tpu.data.pipeline import (device_mix_and_stft_denoiser as jax_mix_den,
                                   device_mix_and_stft_detector as jax_mix_det)
from sos_tpu.dsp.crm import apply_compressed_crm as jax_apply_crm
from sos_tpu.models.denoiser import JointDenoiser as JaxJointDenoiser
from sos_tpu.train import loop as jloop
from sos_tpu_torch.data.pipeline import (
    device_mix_and_stft_denoiser as port_mix_den)
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax
from sos_tpu_torch.models.layers import batch_norms, exact_fp32
from sos_tpu_torch.train import loop as tloop

from tests.torch_port_fixtures import (make_clips, oracle_variables,
                                       tiny_configs)

STEPS_PER_EPOCH = 4
REPO = Path(__file__).resolve().parents[1]
# `sos_tpu`'s bf16 rounded where its dtypes say; XLA reads its flags once
# a process, so those steps run in a process of their own
STRICT_BF16 = "--xla_allow_excess_precision=false"


@pytest.fixture(scope="module")
def setup():
    cfg, pcfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=3)
    return cfg, pcfg, det_vars, den_vars


def _batch(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    bits = (rng.random((n, 60)) < 0.5).astype(np.float32)
    bits[:, :5] = 0.0  # every clip has a silent run
    return {"clean": make_clips(n, seed),
            "noise": (rng.standard_normal((n, 28000)) * 0.1).astype(np.float32),
            "snr": np.asarray([0.0, 5.0, -5.0, 10.0][:n], np.float32),
            "bits": bits}


def _jax_step(cfg, stage, variables, batch):
    """`sos_tpu`'s loss, gradients and new batch stats for one step (the
    body of its jitted train step, with the gradients kept)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if stage == "detector":
        model, _ = jloop.init_detector_state(cfg, STEPS_PER_EPOCH,
                                             variables=variables)
        prep = jax_mix_det(jb["clean"], jb["noise"], jb["snr"], jb["bits"],
                           cfg.data, cfg.stft)

        def loss_fn(params):
            outs, mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                prep["audio"], num_frames=cfg.data.clip_frames, train=True,
                mutable=["batch_stats"])
            return jloop._bce_with_logits(outs, prep["label"]), mut["batch_stats"]
    else:
        model, _ = jloop.init_denoiser_state(cfg, STEPS_PER_EPOCH,
                                             variables=variables)
        d = jax_mix_den(jb["clean"], jb["noise"], jb["snr"], jb["bits"],
                        cfg.data, cfg.stft)

        def loss_fn(params):
            (noise_pred, mask), mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                d["mixed"], d["noise"], train=True, mutable=["batch_stats"])
            rec = jax_apply_crm(d["mixed"], mask)
            loss = (jnp.mean((noise_pred - d["full_noise"]) ** 2)
                    + jnp.mean((rec - d["clean"]) ** 2))
            return loss, mut["batch_stats"]
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(
        np.asarray, stats)


def _jax_denoiser_grads64(cfg, pcfg, variables, batch, stage1=False,
                          noise=0.0):
    """`sos_tpu`'s denoiser gradients evaluated in float64, in the port's
    layout, on the inputs the port's device stage made (that stage is
    held against `sos_tpu`'s in tests/test_torch_train_data.py): of the
    stage-1 loss alone (`stage1`) or of the full step. `sos_tpu`'s BiLSTM
    runs float32 by construction (`sos_tpu/ops/lstm.py:43`), so its
    parameters stay float32; the rest is float64. `noise`: relative
    Gaussian noise (seeded) on those inputs."""
    d = port_mix_den(*(torch.from_numpy(batch[k]) for k in
                       ("clean", "noise", "snr", "bits")),
                     pcfg.data, pcfg.stft)
    rng = np.random.default_rng(0)
    d = {k: v.numpy().astype(np.float64) for k, v in d.items()}
    d = {k: v * (1.0 + noise * rng.standard_normal(v.shape))
         for k, v in d.items()}
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                    tree)
    with jax.enable_x64():
        model = JaxJointDenoiser(cfg.denoiser, compute_dtype="float64")
        d = f64(d)
        params = dict(f64(variables["params"]))
        params["context"] = dict(params["context"],
                                 lstm=variables["params"]["context"]["lstm"])

        def loss_fn(params):
            (noise_pred, mask), _ = model.apply(
                {"params": params, "batch_stats": f64(variables["batch_stats"])},
                d["mixed"], d["noise"], train=True, mutable=["batch_stats"])
            loss = jnp.mean((noise_pred - d["full_noise"]) ** 2)
            if not stage1:
                rec = jax_apply_crm(d["mixed"], mask)
                loss = loss + jnp.mean((rec - d["clean"]) ** 2)
            return loss
        grads = jax.grad(loss_fn)(params)
    return denoiser_from_jax({
        "params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads),
        "batch_stats": variables["batch_stats"]})


def _port_state(pcfg, stage, variables, remat=True):
    pcfg = copy.deepcopy(pcfg)
    object.__setattr__(pcfg.train, "remat", remat)
    convert = detector_from_jax if stage == "detector" else denoiser_from_jax
    init = (tloop.init_detector_state if stage == "detector"
            else tloop.init_denoiser_state)
    return init(pcfg, device="cpu", state_dict=convert(variables))[1], pcfg


def _port_grads(pcfg, stage, state, batch):
    loss_fn = tloop.detector_loss if stage == "detector" else tloop.denoiser_loss
    make_inputs = (tloop.detector_inputs if stage == "detector"
                   else tloop.denoiser_inputs)
    state.model.train()
    with exact_fp32():
        loss = loss_fn(pcfg, state.model, make_inputs(pcfg, batch, "cpu"))[0]
        loss.backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    for bn in batch_norms(state.model):
        bn.pending_stats = None
    return float(loss.detach()), grads


def _max_errors(grads, ref):
    """Per tensor: |port - ref| max over the ref's max |g|."""
    return {n: float((g - ref[n]).abs().max()) / float(ref[n].abs().max())
            for n, g in grads.items()}


def _relative_l2(grads, ref) -> float:
    num = sum(float(((g - ref[n]) ** 2).sum()) for n, g in grads.items())
    return (num / sum(float((ref[n] ** 2).sum()) for n in grads)) ** 0.5


# the denoiser's stage-2 BiLSTM and heads
HEADS = ("context.lstm.", "context.fc")


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_train_step_matches_sos_tpu(setup, stage):
    cfg, pcfg, det_vars, den_vars = setup
    variables = det_vars if stage == "detector" else den_vars
    batch = _batch(11)
    ref_loss, ref_grads, ref_stats = _jax_step(cfg, stage, variables, batch)
    convert = detector_from_jax if stage == "detector" else denoiser_from_jax
    ref = convert({"params": ref_grads, "batch_stats": ref_stats})

    state, pcfg = _port_state(pcfg, stage, variables)
    loss, grads = _port_grads(pcfg, stage, state, batch)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert grads.keys() == {k for k in ref if "running" not in k}
    errors = _max_errors(grads, ref)
    if stage == "detector":
        assert max(errors.values()) <= 1e-4, errors
    else:
        assert _relative_l2(grads, ref) <= 1e-2
        assert all(e <= 5e-2 for n, e in errors.items()
                   if grads[n].numel() > 1), errors
        # stage 1 alone against sos_tpu's InpaintNet in float64
        state1, _ = _port_state(pcfg, stage, variables)
        state1.model.train()
        with exact_fp32():
            loss1 = tloop.denoiser_loss(
                pcfg, state1.model, tloop.denoiser_inputs(pcfg, batch, "cpu"))[1]
            loss1.backward()
        g1 = {n: p.grad for n, p in state1.model.named_parameters()
              if n.startswith("inpaint.")}
        ref1 = _jax_denoiser_grads64(cfg, pcfg, variables, batch, stage1=True)
        errors1 = _max_errors(g1, ref1)
        assert max(errors1.values()) <= 1e-4, errors1
        # the full step against sos_tpu in float64: the stage-2 BiLSTM and
        # heads per tensor, and all gradients together
        ref64 = _jax_denoiser_grads64(cfg, pcfg, variables, batch)
        errors64 = _max_errors(grads, ref64)
        assert max(e for n, e in errors64.items()
                   if n.startswith(HEADS)) <= 1e-4, errors64
        assert _relative_l2(grads, ref64) <= 1e-2

    make = (tloop.make_detector_train_step if stage == "detector"
            else tloop.make_denoiser_train_step)
    _, metrics = make(pcfg, STEPS_PER_EPOCH)(state, batch)
    assert abs(metrics["loss"] - ref_loss) <= 1e-5 * abs(ref_loss)
    assert metrics["finite"] == 1.0 and metrics["lr"] == pcfg.train.lr
    keys = set(metrics)
    assert keys == ({"loss", "accuracy", "finite", "lr"} if stage == "detector"
                    else {"loss", "stage1", "stage2", "finite", "lr"})
    new = state.model.state_dict()
    running = [k for k in ref if "running" in k]
    assert running
    for name in running:
        torch.testing.assert_close(new[name], ref[name], atol=1e-6, rtol=0)


def test_denoiser_exact_gradient_moves_under_input_rounding(setup):
    """Why two fp32 evaluations of the denoiser's step get no per-tensor
    bound on the trunks' gradients: `sos_tpu`'s gradient evaluated in
    float64 itself moves by more than 1e-3 of a tensor's max |g| when the
    step's inputs move by 1e-7 relative (fp32 rounding's size; batch
    seed 13), while the stage-2 BiLSTM's and heads' move by under 1e-4:
    the trunks' ReLU/PReLU kinks, not the arithmetic."""
    cfg, pcfg, _, den_vars = setup
    batch = _batch(13)
    ref = _jax_denoiser_grads64(cfg, pcfg, den_vars, batch)
    moved = _max_errors(_jax_denoiser_grads64(cfg, pcfg, den_vars, batch,
                                              noise=1e-7), ref)
    assert max(e for n, e in moved.items() if ref[n].numel() > 1
               and not n.startswith(HEADS)) > 1e-3, moved
    assert max(e for n, e in moved.items() if n.startswith(HEADS)) < 1e-4


def test_adam_matches_optax_from_identical_gradients(setup):
    cfg, pcfg, det_vars, _ = setup
    _, grads, stats = _jax_step(cfg, "detector", det_vars, _batch(12))
    tx = jloop.make_optimizer(cfg, STEPS_PER_EPOCH)
    params = det_vars["params"]
    opt_state = tx.init(params)
    for _ in range(3):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    ref = detector_from_jax({"params": jax.tree.map(np.asarray, params),
                             "batch_stats": stats})

    state, _ = _port_state(pcfg, "detector", det_vars)
    g = detector_from_jax({"params": grads, "batch_stats": stats})
    for _ in range(3):
        for name, p in state.model.named_parameters():
            p.grad = g[name].clone()
        state.optimizer.step()
    assert tloop.adam_count(state.optimizer) == 3
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), ref[name], atol=1e-7,
                                   rtol=4e-7)


def test_remat_on_and_off_give_the_same_step(setup):
    """Rematerialisation runs each block's forward twice; the step (loss,
    parameters) is the same, and BatchNorm's statistics are applied once:
    `0.9 * old + 0.1 * batch`, not twice."""
    cfg, pcfg, _, den_vars = setup
    batch = _batch(13)
    out = {}
    for remat in (True, False):
        state, cfg_r = _port_state(pcfg, "denoiser", den_vars, remat)
        assert state.model.inpaint.remat is remat
        old = {n: b.clone() for n, b in state.model.named_buffers()}
        _, metrics = tloop.make_denoiser_train_step(cfg_r, STEPS_PER_EPOCH)(
            state, batch)
        out[remat] = (metrics["loss"], state.model.state_dict(), old)
    (l_on, s_on, old), (l_off, s_off, _) = out[True], out[False]
    assert l_on == pytest.approx(l_off, rel=1e-6)
    for name in s_on:
        torch.testing.assert_close(s_on[name], s_off[name], atol=1e-6,
                                   rtol=1e-6, msg=name)
    # once, not twice: the new mean sits 0.1 of the way from the old one
    # to the batch's, which the same step without remat also moves
    name = "inpaint.a_in.bn.running_mean"
    moved = s_on[name] - old[name]
    assert float(moved.abs().max()) > 1e-4
    torch.testing.assert_close(moved, s_off[name] - old[name], atol=1e-7,
                               rtol=0)


def _snapshot(state):
    opt = {k: {kk: (vv.clone() if torch.is_tensor(vv) else vv)
               for kk, vv in v.items()}
           for k, v in state.optimizer.state_dict()["state"].items()}
    return state.model.state_dict(), opt


def _nan_batch(seed):
    batch = _batch(seed)
    batch["noise"] = batch["noise"].copy()
    batch["noise"][0, 100] = np.nan
    return batch


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_nonfinite_batch_is_skipped_bit_exactly(setup, stage):
    _, pcfg, det_vars, den_vars = setup
    variables = det_vars if stage == "detector" else den_vars
    state, pcfg = _port_state(pcfg, stage, variables)
    make = (tloop.make_detector_train_step if stage == "detector"
            else tloop.make_denoiser_train_step)
    step = make(pcfg, STEPS_PER_EPOCH)
    step(state, _batch(14))  # moments and a count to keep
    weights, opt = _snapshot(state)
    _, metrics = step(state, _nan_batch(15))
    assert metrics["finite"] == 0.0
    assert not np.isfinite(metrics["loss"])
    assert state.step == 2 and tloop.adam_count(state.optimizer) == 1
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, weights[name]), name
    after = state.optimizer.state_dict()["state"]
    for k, v in opt.items():
        for kk, vv in v.items():
            assert torch.equal(torch.as_tensor(after[k][kk]),
                               torch.as_tensor(vv)), (k, kk)
    assert all(bn.pending_stats is None for bn in batch_norms(state.model))


def test_lr_staircase_follows_the_optimizer_count(setup):
    """StepLR every 2 applied steps (lr_step_size 1, 2 steps an epoch):
    after a skipped step the staircase lags the step counter by one, as
    `sos_tpu`'s optax count does."""
    _, pcfg, det_vars, _ = setup
    state, pcfg = _port_state(pcfg, "detector", det_vars)
    object.__setattr__(pcfg.train, "lr_step_size", 1)
    step = tloop.make_detector_train_step(pcfg, 2)
    lrs, finite = [], []
    for batch in (_batch(16), _nan_batch(17), _batch(18), _batch(19),
                  _batch(20)):
        _, m = step(state, batch)
        lrs.append(m["lr"])
        finite.append(m["finite"])
    lr, gamma = pcfg.train.lr, pcfg.train.lr_gamma
    assert finite == [1.0, 0.0, 1.0, 1.0, 1.0]
    assert lrs == pytest.approx([lr, lr, lr, lr * gamma, lr * gamma])
    assert state.step == 5 and tloop.adam_count(state.optimizer) == 4
    schedule = tloop.make_lr_schedule(pcfg, 2)
    assert [schedule(c) for c in range(5)] == pytest.approx(
        [lr, lr, lr * gamma, lr * gamma, lr * gamma ** 2])


def test_eval_steps_report_sos_tpu_keys(setup):
    _, pcfg, det_vars, den_vars = setup
    det_state, pcfg = _port_state(pcfg, "detector", det_vars)
    out = tloop.make_detector_eval_step(pcfg)(det_state, _batch(21))
    assert set(out) == {"loss", "accuracy", "pred", "label"}
    assert out["pred"].shape == out["label"].shape == (2, 60)
    den_state, _ = _port_state(pcfg, "denoiser", den_vars)
    out = tloop.make_denoiser_eval_step(pcfg)(den_state, _batch(21))
    assert set(out) == {"stage1", "stage2"}
    assert all(np.isfinite(v) for v in out.values())


def _train_cfg(cfg, compute_dtype: str, remat: bool):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype=compute_dtype, remat=remat))


# the batch seeds over which bf16's move of `sos_tpu`'s step is measured
BF16_SEEDS = tuple(range(11, 19))
# the tier-1 bf16 cases take the first four
BF16_TEST_SEEDS = BF16_SEEDS[:4]


def sos_tpu_steps_main(out: str, cases, seeds, full_depth: bool,
                       weight_seeds=(3,)) -> None:
    """In a process of its own (`sos_tpu_steps`): `sos_tpu`'s train-step
    loss and gradients (in the port's layout) of every `(stage,
    compute_dtype, remat)` case at each batch seed, from the oracle
    weights of `tiny_configs(full_depth)` drawn with each weight seed,
    one compile a case; saved to `out` as
    {"stage/dtype/remat/weight seed/batch seed": {"loss", "grads"}}."""
    jax.config.update("jax_platforms", "cpu")
    cfg, _ = tiny_configs(full_depth)
    weights = {w: dict(zip(("detector", "denoiser"),
                           oracle_variables(cfg, seed=w)))
               for w in weight_seeds}
    results = {}
    for stage, dtype, remat in cases:
        step = jax.jit(_jax_loss_and_grads(_train_cfg(cfg, dtype, remat),
                                           stage, weights[weight_seeds[0]]
                                           [stage]))
        convert = detector_from_jax if stage == "detector" else denoiser_from_jax
        for w in weight_seeds:
            variables = weights[w][stage]
            for seed in seeds:
                batch = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
                loss, grads = step(variables["params"],
                                   variables["batch_stats"], batch)
                grads = convert({"params": jax.tree.map(np.asarray, grads),
                                 "batch_stats": variables["batch_stats"]})
                results[f"{stage}/{dtype}/{remat}/{w}/{seed}"] = {
                    "loss": float(loss),
                    "grads": {k: v for k, v in grads.items()
                              if "running" not in k}}
    torch.save(results, out)


def sos_tpu_steps(tmp_path, cases, seeds=BF16_SEEDS, full_depth=False,
                  weight_seeds=(3,)):
    """`sos_tpu_steps_main`'s results, run in a fresh process with
    STRICT_BF16."""
    out = tmp_path / "sos_tpu_steps.pt"
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"from tests.test_torch_train import sos_tpu_steps_main; "
            f"sos_tpu_steps_main({str(out)!r}, {list(cases)!r}, "
            f"{list(seeds)!r}, {full_depth!r}, {tuple(weight_seeds)!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " " + STRICT_BF16).strip())
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=900)
    return torch.load(out, weights_only=True)


def _jax_loss_and_grads(cfg, stage, variables):
    """`sos_tpu`'s train-step loss as a function of (params, batch
    statistics, batch) -> (loss, gradients), the body of its jitted
    step."""
    init = (jloop.init_detector_state if stage == "detector"
            else jloop.init_denoiser_state)
    model, _ = init(cfg, STEPS_PER_EPOCH, variables=variables)

    def loss_fn(params, batch_stats, b):
        current = {"params": params, "batch_stats": batch_stats}
        if stage == "detector":
            prep = jax_mix_det(b["clean"], b["noise"], b["snr"], b["bits"],
                               cfg.data, cfg.stft)
            logits, _ = model.apply(current, prep["audio"],
                                    num_frames=cfg.data.clip_frames,
                                    train=True, mutable=["batch_stats"])
            return jloop._bce_with_logits(logits, prep["label"])
        d = jax_mix_den(b["clean"], b["noise"], b["snr"], b["bits"],
                        cfg.data, cfg.stft)
        (noise_pred, mask), _ = model.apply(current, d["mixed"], d["noise"],
                                            train=True,
                                            mutable=["batch_stats"])
        rec = jax_apply_crm(d["mixed"], mask)
        return (jnp.mean((noise_pred - d["full_noise"]) ** 2)
                + jnp.mean((rec - d["clean"]) ** 2))
    return jax.value_and_grad(loss_fn)


def bf16_gap(steps, key, loss=None, grads=None):
    """(relative loss gap, relative L2 of all gradients) of a bf16 step
    against `sos_tpu`'s, `key` = "stage/remat/weight seed/batch seed":
    `sos_tpu`'s bf16 step against its f32 step when `loss`/`grads` are
    None (the yardstick), else the given ones against its bf16 step."""
    stage, remat, rest = key.split("/", 2)
    ref = steps[f"{stage}/bfloat16/{remat}/{rest}"]
    if loss is None:
        loss, grads = ref["loss"], ref["grads"]
        ref = steps[f"{stage}/float32/False/{rest}"]
    return (abs(loss - ref["loss"]) / abs(ref["loss"]),
            _relative_l2(grads, ref["grads"]))


@pytest.fixture(scope="module")
def bf16_steps(tmp_path_factory):
    """`sos_tpu`'s f32 and bf16 steps, without remat (the port's steps
    with remat on and off are both held to them)."""
    cases = [(stage, dtype, False) for stage in ("detector", "denoiser")
             for dtype in ("float32", "bfloat16")]
    return sos_tpu_steps(tmp_path_factory.mktemp("bf16"), cases,
                         seeds=BF16_TEST_SEEDS)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_bf16_step_matches_sos_tpu(setup, bf16_steps, stage, remat):
    """The port's bf16 step (bf16 trunks), remat on and off, against
    `sos_tpu`'s (strict bf16) on the same weights, at each batch seed of
    BF16_TEST_SEEDS: within the yardstick, the farthest bf16 moves
    `sos_tpu`'s step from its f32 step over those batches, in both
    measures. (At one batch the two bf16 steps' 1-ulp differences,
    accumulated over the denoiser's 19 InpaintNet blocks, can put the
    loss past that batch's own gap.)"""
    _, pcfg, det_vars, den_vars = setup
    variables = det_vars if stage == "detector" else den_vars
    yard = [bf16_gap(bf16_steps, f"{stage}/False/3/{seed}")
            for seed in BF16_TEST_SEEDS]
    yard_loss, yard_grads = (max(g) for g in zip(*yard))
    got = []
    for seed in BF16_TEST_SEEDS:
        state, cfg = _port_state(_train_cfg(pcfg, "bfloat16", remat), stage,
                                 variables, remat)
        loss, grads = _port_grads(cfg, stage, state, _batch(seed))
        got.append(bf16_gap(bf16_steps, f"{stage}/False/3/{seed}", loss,
                            grads))
    got_loss, got_grads = (max(g) for g in zip(*got))
    print(f"bf16 {stage} remat {remat}, batch seeds {BF16_TEST_SEEDS[0]}-"
          f"{BF16_TEST_SEEDS[-1]}: sos_tpu bf16 against its f32 (yardstick), "
          f"worst loss {yard_loss:.3e}, gradients {yard_grads:.3e}; the "
          f"port's bf16 against sos_tpu's bf16, worst loss {got_loss:.3e}, "
          f"gradients {got_grads:.3e}")
    assert got_loss <= yard_loss and got_grads <= yard_grads


def test_training_refuses_bfloat16(setup):
    """The bf16 refusal is lifted: `compute_dtype="bfloat16"` trains the
    conv trunks in bf16 (their activations are bf16), while the BiLSTM,
    the heads and the loss stay float32, as in `sos_tpu`; a train step
    runs and applies."""
    _, pcfg, det_vars, _ = setup
    state, pcfg = _port_state(_train_cfg(pcfg, "bfloat16", False),
                              "detector", det_vars, remat=False)
    assert state.model.dtype == torch.bfloat16
    seen = {}
    hooks = [state.model.conv0.register_forward_hook(
                 lambda m, i, o: seen.update(trunk=o.dtype)),
             state.model.fc2.register_forward_hook(
                 lambda m, i, o: seen.update(head=o.dtype))]
    _, metrics = tloop.make_detector_train_step(pcfg, STEPS_PER_EPOCH)(
        state, _batch(22))
    for h in hooks:
        h.remove()
    assert seen == {"trunk": torch.bfloat16, "head": torch.float32}
    assert metrics["finite"] == 1.0 and np.isfinite(metrics["loss"])
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_batchnorm_training_matches_flax_biased_update():
    """Training-mode `TorchBatchNorm` against `sos_tpu`'s (flax, momentum
    0.9) at n = 8 values a channel, where the unbiased variance torch's
    own `batch_norm(training=True)` would fold in is 8/7 of the biased
    one: the output, and the running statistics after one commit, within
    1e-6; they stay pending (buffers untouched) until committed."""
    from sos_tpu.models.layers import TorchBatchNorm as JaxBatchNorm
    from sos_tpu_torch.models.layers import TorchBatchNorm

    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 3, 2, 2)) * 2 + 1).astype(np.float32)
    mean0 = rng.standard_normal(3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    y_ref, mutated = JaxBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
        mutable=["batch_stats"])
    stats = mutated["batch_stats"]["BatchNorm_0"]

    bn = TorchBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_ref), atol=1e-6)
    assert torch.equal(bn.running_var, torch.from_numpy(var0))  # pending
    bn.commit_stats()
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)
    unbiased = torch.from_numpy(var0).clone()
    torch.nn.functional.batch_norm(torch.from_numpy(x),
                                   torch.from_numpy(mean0).clone(), unbiased,
                                   training=True, momentum=0.1)
    biased_part = np.asarray(stats["var"]) - 0.9 * var0
    np.testing.assert_allclose(unbiased.numpy() - 0.9 * var0,
                               biased_part * 8 / 7, rtol=1e-5)
