"""Data parallelism of the port on the CPU: training in a gloo process
group of 2 processes (`sos_tpu_torch.parallel.distributed`, sync-BN in
`models/layers.py`) and data-parallel inference in one process
(`FusedDenoisePipeline.shard`), at the tiny widths of
tests/torch_port_fixtures.py.

* Two gloo ranks, each on half of a global batch of 4 (one detector,
  one denoiser and one joint step; remat on, so each BatchNorm runs its
  all-reduce again in the backward): the ranks hold bit-identical
  parameters and statistics after the step, and match the port's
  single-process step on the global batch (loss 1e-6 relative, BatchNorm
  statistics 1e-6, the gradients Adam steps with 1e-5 relative L2, the
  parameters after the step 1e-6 relative L2). The denoiser's InpaintNet
  gradients are held within 1e-3: the same step in one process, on the
  batch with its rows swapped, moves them by 2.3e-4 (fp32 sums in
  another order; `GRAD_BOUNDS`).
* The same 2-rank steps against `sos_tpu`'s single-process step on the
  global batch, at tests/test_torch_train.py's and
  tests/test_torch_joint.py's tolerances for the single-device step
  (loss 1e-5 relative; statistics 1e-6; detector gradients 1e-4 of each
  tensor's max |g|; denoiser 1e-2 relative L2 and 5e-2 of each tensor's
  max |g|); the joint step part by part, as `sos_tpu/train/joint.py`
  composes it: the detector's BCE on the denoiser's mixed STFT and the
  denoiser's own step, each of `sos_tpu`'s steps computed once for the
  module. `sos_tpu`'s tests/test_multihost.py shows its multi-process
  step equals its single-process one, so this holds the port to its
  sync-BN semantics without JAX in several processes.
* Sync-BN in float64: `batch_moments`' differentiable all-reduce passes
  `torch.autograd.gradcheck` in a 1-rank group, and over 2 ranks gives
  the plain BatchNorm of the concatenated batch, output and input
  gradient, within 1e-12.
* `train_detector --device cpu --num_devices 2`, then `--continue`.
* `shard(["cpu", "cpu"])` against the unsharded call (1e-6, equal bits)
  and against `sos_tpu`'s unsharded call (1e-4; int8 the 5e-3 int8
  budget of tests/test_torch_quant.py, one scale file), f32 and int8.

The group's processes start once for the module (a fresh interpreter
each, `tests/torch_parallel_worker.py`, no JAX) under a timeout of
their own.
"""

import json
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sos_tpu.data.pipeline import device_mix_and_stft_denoiser as jax_mix_den
from sos_tpu.infer.fused import FusedDenoisePipeline as JaxPipeline
from sos_tpu.train import loop as jloop
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax
from sos_tpu_torch.models.layers import batch_moments
from sos_tpu_torch.parallel import distributed, make_mesh, shard_batch
from sos_tpu_torch.parallel.distributed import free_port

from tests import torch_parallel_worker as worker
from tests.test_torch_train import (STEPS_PER_EPOCH, _batch, _jax_step,
                                    _max_errors)
from tests.torch_port_fixtures import (make_clips, oracle_variables,
                                       port_states, tiny_configs,
                                       training_corpus)

WORLD = 2
GLOBAL_BATCH = 4
GROUP_TIMEOUT_S = 240
CASES = ("detector", "denoiser", "joint")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch on 2 threads in this module (tiny widths): the suite's other
    workers share the host's cores, and more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg, pcfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=3)
    rng = np.random.default_rng(12)
    inputs = {"cfg": pcfg.to_json(), "batch": _batch(11, GLOBAL_BATCH),
              "detector": detector_from_jax(det_vars),
              "denoiser": denoiser_from_jax(den_vars),
              "bn_x": torch.from_numpy(rng.standard_normal((4, 3, 5, 6)) * 2
                                       + 1),
              "bn_g": torch.from_numpy(rng.standard_normal((4, 3, 5, 6)))}
    return cfg, pcfg, det_vars, den_vars, inputs


def _run_group(inputs, path: Path):
    torch.save(inputs, path / "inputs.pt")
    ctx = mp.start_processes(worker.worker,
                             args=(WORLD, free_port(), str(path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo group did not finish in "
                        f"{GROUP_TIMEOUT_S} s")
    return [torch.load(path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    return _run_group(setup[4], tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def single(setup):
    """The port's step in this process, on the whole global batch, and
    the denoiser's on the same batch with its halves swapped (the same
    step, summed in another order)."""
    inputs = setup[4]
    swapped = dict(inputs, batch={k: np.concatenate([v[2:], v[:2]])
                                  for k, v in inputs["batch"].items()})
    return {"steps": worker.train_steps(inputs),
            "swapped": worker.train_steps(swapped, cases=("denoiser",)),
            "bn": worker.sync_bn_float64(inputs)}


def _flat(tree, prefix=""):
    """{name: tensor} of nested dicts of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _relative_l2(got, ref, prefix: str = "") -> float:
    names = [n for n in ref if n.startswith(prefix)]
    num = sum(float(((got[n].double() - ref[n].double()) ** 2).sum())
              for n in names)
    return (num / sum(float((ref[n].double() ** 2).sum())
                      for n in names)) ** 0.5


# relative L2 bound of the gradients against the one-process step, per
# part: 1e-5, but 1e-3 for the denoiser's InpaintNet, whose fp32 gradient
# moves by ~1e-4 when the same batch is only summed in another order
# (`test_inpaint_gradient_floor_in_one_process`: its rows swapped in one
# process, measured 2.3e-4); the 2-rank step sums its BatchNorm moments
# and the gradient average in another order too
GRAD_BOUNDS = {"detector": {"": 1e-5},
               "denoiser": {"context.": 1e-5, "inpaint.": 1e-3},
               "joint": {"detector.": 1e-5, "denoiser.context.": 1e-5,
                         "denoiser.inpaint.": 1e-3}}


LOSSES = {"detector": ("loss",), "denoiser": ("loss",),
          "joint": ("detector_loss", "denoiser_loss")}


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_identical_state(ranks, case):
    a, b = (_flat(r["steps"][case]["state"]) for r in ranks)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert ranks[0]["steps"][case]["metrics"] == \
        ranks[1]["steps"][case]["metrics"]


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_one_process(ranks, single, case):
    got, ref = ranks[0]["steps"][case], single["steps"][case]
    for key in LOSSES[case]:
        assert abs(got["metrics"][key] - ref["metrics"][key]) \
            <= 1e-6 * abs(ref["metrics"][key]), key
    assert got["metrics"]["finite"] == 1.0
    for name, t in ref["stats"].items():
        torch.testing.assert_close(got["stats"][name], t, atol=1e-6, rtol=0)
    g, rg = _flat(got["grads"]), _flat(ref["grads"])
    assert g.keys() == rg.keys()
    for prefix, bound in GRAD_BOUNDS[case].items():
        assert _relative_l2(g, rg, prefix) <= bound, prefix
    params = {n: t for n, t in _flat(ref["state"]).items()
              if "running" not in n}
    assert _relative_l2(_flat(got["state"]), params) <= 1e-6


def _jax_joint_detector_step(cfg, det_vars, batch):
    """The detector's part of `sos_tpu`'s joint step (the body of
    `make_joint_train_step`'s `det_loss_fn`: its BCE on the denoiser's
    mixed STFT): loss, gradients and new statistics."""
    model, _ = jloop.init_detector_state(cfg, STEPS_PER_EPOCH,
                                         variables=det_vars)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    d = jax_mix_den(jb["clean"], jb["noise"], jb["snr"], jb["bits"],
                    cfg.data, cfg.stft)

    def loss_fn(params):
        logits, mut = model.apply(
            {"params": params, "batch_stats": det_vars["batch_stats"]},
            d["mixed"], num_frames=cfg.data.clip_frames, train=True,
            mutable=["batch_stats"])
        return jloop._bce_with_logits(logits, jb["bits"]), mut["batch_stats"]
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        det_vars["params"])
    return float(loss), jax_tree(grads), jax_tree(stats)


@pytest.fixture(scope="module")
def sos_tpu_steps(setup):
    """`sos_tpu`'s single-process steps on the global batch, each once:
    {part: (loss, gradients and new statistics in the port's layout)}.
    Its joint step's parts are the detector's BCE on the denoiser's mixed
    STFT and the denoiser's own train step (`sos_tpu/train/joint.py`
    `det_loss_fn`, `den_loss_fn`)."""
    cfg, _, det_vars, den_vars, inputs = setup
    batch = inputs["batch"]
    out = {}
    for part, convert, (loss, grads, stats) in (
            ("detector", detector_from_jax,
             _jax_step(cfg, "detector", det_vars, batch)),
            ("denoiser", denoiser_from_jax,
             _jax_step(cfg, "denoiser", den_vars, batch)),
            ("joint_detector", detector_from_jax,
             _jax_joint_detector_step(cfg, det_vars, batch))):
        out[part] = (loss, convert({"params": grads, "batch_stats": stats}))
    return out


# per case: (part of `sos_tpu_steps`, the port's loss metric, the prefix
# of the port's gradients and statistics)
SOS_TPU_PARTS = {"detector": (("detector", "loss", ""),),
                 "denoiser": (("denoiser", "loss", ""),),
                 "joint": (("joint_detector", "detector_loss", "detector."),
                           ("denoiser", "denoiser_loss", "denoiser."))}


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_sos_tpu(sos_tpu_steps, ranks, case):
    got = ranks[0]["steps"][case]
    for part, loss_key, prefix in SOS_TPU_PARTS[case]:
        ref_loss, ref = sos_tpu_steps[part]
        grads = got["grads"][prefix[:-1]] if prefix else got["grads"]
        stats = {k[len(prefix):]: v for k, v in got["stats"].items()
                 if k.startswith(prefix)}
        assert abs(got["metrics"][loss_key] - ref_loss) \
            <= 1e-5 * abs(ref_loss), loss_key
        errors = _max_errors(grads, ref)
        if part == "denoiser":
            assert _relative_l2(grads, {n: ref[n] for n in grads}) <= 1e-2
            assert all(e <= 5e-2 for n, e in errors.items()
                       if grads[n].numel() > 1), errors
        else:
            assert max(errors.values()) <= 1e-4, (part, errors)
        names = [n for n in ref if "running" in n]
        assert names and set(names) == set(stats)
        for name in names:
            torch.testing.assert_close(stats[name], ref[name], atol=1e-6,
                                       rtol=0)


def test_inpaint_gradient_floor_in_one_process(single):
    """The witness for GRAD_BOUNDS: in one process, the denoiser step on
    the batch with its rows swapped moves the InpaintNet's gradients by
    more than 1e-5 relative L2 (fp32 sums in another order), the rest of
    the denoiser's by less."""
    ref, swapped = single["steps"], single["swapped"]
    den = (swapped["denoiser"]["grads"], ref["denoiser"]["grads"])
    assert 1e-5 < _relative_l2(*den, "inpaint.") <= 1e-3
    assert _relative_l2(*den, "context.") <= 1e-5


def jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_sync_batchnorm_two_ranks_match_the_concatenated_batch(ranks,
                                                               single):
    ref = single["bn"]
    for key in ("y", "dx"):
        got = torch.cat([r["bn"][key] for r in ranks])
        torch.testing.assert_close(got, ref[key], atol=1e-12, rtol=0)
    for r in ranks:
        for key in ("mean", "var"):
            torch.testing.assert_close(r["bn"][key], ref[key], atol=1e-12,
                                       rtol=0)


def test_sync_batchnorm_gradcheck_in_one_rank_group(setup):
    """The all-reduced moments and their backward (`_GroupSum`) in a
    process group of one, in float64, against finite differences."""
    x = setup[4]["bn_x"][:2].clone().requires_grad_(True)
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, require=True,
                           device="cpu")
    try:
        assert distributed.is_initialized()
        assert torch.autograd.gradcheck(batch_moments, (x,), eps=1e-6,
                                        atol=1e-8)
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()


def test_distributed_without_a_group_to_join_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize(require=True, device="cpu")
    distributed.initialize(device="cpu")  # not required: one process
    assert not distributed.is_initialized()
    assert distributed.process_local_batch_size(15) == 15


def test_mesh_splits_in_order_and_refuses_uneven_batches():
    mesh = make_mesh(devices=["cpu", "cpu"])
    parts = shard_batch({"x": np.arange(6).reshape(6, 1)}, mesh)
    assert [p["x"][:, 0].tolist() for p in parts] == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="divide the mesh size 2"):
        shard_batch(np.zeros((3, 1)), mesh)


def _strict(text: str):
    return json.loads(text, parse_constant=lambda c: pytest.fail(
        f"non-strict JSON token {c}"))


def test_train_cli_data_parallel_on_cpu(tmp_path, capfd):
    """`train_detector --device cpu --num_devices 2`: this process spawns
    two gloo processes, one experiment (process 0 writes the checkpoints
    and each log row once), then `--continue --ckpt latest` to epoch 2."""
    from sos_tpu_torch.cli import train_detector

    ds_json, noise_dir = training_corpus(tmp_path)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tiny_configs()[1].to_json())

    def run(*extra):
        train_detector.main([
            "--device", "cpu", "--num_devices", "2", "--config_json",
            str(cfg), "--dataset_json", ds_json, "--noise_root", noise_dir,
            "--output_root", str(tmp_path / "out"), "--name", "tiny",
            "--batch_size", "4", *extra])
        return capfd.readouterr()

    run("--epochs", "1")
    assert sorted(os.listdir(tmp_path / "out")) == ["tiny_detector"]
    model_dir = tmp_path / "out" / "tiny_detector" / "model"
    assert {"latest.pt", "ckpt_epoch1.pt", "latest.clock.json"} <= set(
        os.listdir(model_dir))
    assert not [f for f in os.listdir(model_dir) if f.endswith(".tmp")]
    clock1 = _strict((model_dir / "latest.clock.json").read_text())
    assert clock1["epoch"] == 1 and clock1["step"] >= 1
    log = tmp_path / "out" / "tiny_detector" / "log" / "metrics.jsonl"
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    keys = [(r["kind"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys))  # one row an event
    assert [k for k in keys if k[0] == "epoch"] == [("epoch",
                                                     clock1["step"])]
    second = run("--epochs", "2", "--continue", "--ckpt", "latest")
    assert second.out.count("resumed from latest at epoch 1") == 1
    clock2 = _strict((model_dir / "latest.clock.json").read_text())
    assert clock2["epoch"] == 2 and clock2["step"] == 2 * clock1["step"]


@pytest.fixture(scope="module")
def shard_env():
    cfg, pcfg = tiny_configs()
    det_vars, den_vars = oracle_variables(cfg, seed=1)
    # a sharper head, so the random detector's bits sit clear of the
    # threshold (as tests/test_torch_fused.py)
    fc2 = det_vars["params"]["fc2"]
    fc2["kernel"], fc2["bias"] = fc2["kernel"] * 40, fc2["bias"] * 40
    det_state, den_state = port_states(det_vars, den_vars)
    return cfg, pcfg, det_vars, den_vars, det_state, den_state, \
        make_clips(4, seed=23)


@pytest.mark.parametrize("profile", ["f32", "int8"])
def test_shard_matches_the_unsharded_call(shard_env, profile, tmp_path):
    cfg, pcfg, det_vars, den_vars, det_state, den_state, clips = shard_env
    calib = None
    jax_kw = {}
    if profile == "int8":
        calib = str(tmp_path / "int8_calibration.json")
        jax_kw = dict(profile="int8", calibration_path=calib)
    ref_y, ref_bits = (np.asarray(a) for a in
                       JaxPipeline(cfg, det_vars, den_vars, **jax_kw)(clips))
    one = FusedDenoisePipeline(pcfg, det_state, den_state, profile=profile,
                               calibration_path=calib, device="cpu")
    two = FusedDenoisePipeline(pcfg, det_state, den_state, profile=profile,
                               calibration_path=calib,
                               device="cpu").shard(["cpu", "cpu"])
    assert len(two._replicas) == 2 and two._replicas[1] is not two
    y1, b1 = one(clips)
    y2, b2 = two(clips)
    assert torch.equal(b1, b2)
    torch.testing.assert_close(y2, y1, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b2.numpy(), ref_bits)
    # int8: the int8 budget the unsharded port keeps to sos_tpu's int8
    # (tests/test_torch_quant.py: a requantize tie in float32 may round a
    # value one int8 step apart)
    np.testing.assert_allclose(y2.numpy(), ref_y, rtol=1e-3,
                               atol=1e-4 if profile == "f32" else 5e-3)
    torch.testing.assert_close(two.detect_bits(clips), one.detect_bits(clips),
                               atol=0, rtol=0)
    torch.testing.assert_close(two.denoise_with_bits(clips, b1),
                               one.denoise_with_bits(clips, b1), atol=1e-6,
                               rtol=0)
    if profile == "int8":
        rep = two._replicas[1]
        assert rep._quant.calibration_state() == \
            one._quant.calibration_state()
