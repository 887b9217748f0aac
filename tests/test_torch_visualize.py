"""The port's training visualizer (`train/visualize.py`) and `fit`'s
`visualize_hook`, against `sos_tpu`'s on the CPU.

* the six panel waveforms equal `sos_tpu`'s `istft` of the same panels
  (its `apply_compressed_crm` then `istft` for `denoised`) within atol
  1e-5 + rtol 1e-5 (fp32 sums in another order);
* the rendered image equals `sos_tpu`'s `visualize_denoiser_batch` image,
  given a recording writer, up to one level on at most 0.1 % of its
  values (the waveforms differ in their last bits; 27 of 3.6 M differ);
* `fit(visualize_hook=...)` with `visualize_frequency` 2 over 4 steps
  calls the hook as `sos_tpu`'s fit does, at the pre-tick step counts 0
  and 2, on process 0 only (another process, over 2 steps, never); the
  denoiser's hook renders one image in eval mode;
* `writer=None` returns without work.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.data.pipeline import device_mix_and_stft_denoiser as jax_prepare
from sos_tpu.train import visualize as jax_vis
from sos_tpu_torch.parallel import distributed
from sos_tpu_torch.train import loop
from sos_tpu_torch.train import fit as fit_module
from sos_tpu_torch.train import visualize as vis
from sos_tpu_torch.train.fit import fit
from sos_tpu_torch.train.state import TrainClock

from tests.torch_port_fixtures import CLIP, make_clips, tiny_configs

jcrm = importlib.import_module("sos_tpu.dsp.crm")
jstft = importlib.import_module("sos_tpu.dsp.stft")


class RecordingWriter:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, np.array(img), global_step))


def _batch(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"clean": make_clips(n, seed),
            "noise": (rng.standard_normal((n, CLIP)) * 0.2).astype(np.float32),
            "snr": rng.uniform(-5, 5, n).astype(np.float32),
            "bits": (np.arange(60)[None] // 15 % 2
                     * np.ones((n, 1))).astype(np.float32)}


@pytest.fixture(scope="module")
def panels():
    """sos_tpu's device stage on one batch, a predicted noise and a cRM;
    the same arrays for both packages."""
    cfg, _ = tiny_configs()
    b = _batch(2, 3)
    prepared = jax_prepare(*(jnp.asarray(b[k]) for k in
                             ("clean", "noise", "snr", "bits")),
                           cfg.data, cfg.stft)
    rng = np.random.default_rng(4)
    noise_pred = np.asarray(prepared["full_noise"]) * 0.7
    mask = rng.uniform(0.2, 0.8, noise_pred.shape).astype(np.float32)
    port = {k: torch.from_numpy(np.array(v)) for k, v in prepared.items()}
    return (prepared, jnp.asarray(noise_pred), jnp.asarray(mask), port,
            torch.from_numpy(noise_pred.copy()), torch.from_numpy(mask))


def test_panel_waves_match_sos_tpu(panels):
    prepared, noise_pred, mask, port, p_noise, p_mask = panels
    waves = vis.denoiser_panel_waves(port, p_noise, p_mask, n=2)
    assert tuple(waves) == vis.PANELS
    spectra = [prepared["mixed"], prepared["noise"], prepared["full_noise"],
               noise_pred, prepared["clean"],
               jcrm.apply_compressed_crm(prepared["mixed"], mask)]
    for name, spec in zip(vis.PANELS, spectra):
        ref = np.asarray(jstft.istft(spec[:2]))
        assert waves[name].shape == ref.shape == (2, 27966), name
        np.testing.assert_allclose(waves[name].numpy(), ref, atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_rendered_image_matches_sos_tpu(panels):
    prepared, noise_pred, mask, port, p_noise, p_mask = panels
    ref, got = RecordingWriter(), RecordingWriter()
    jax_vis.visualize_denoiser_batch(ref, prepared, noise_pred, mask, 7)
    vis.visualize_denoiser_batch(got, port, p_noise, p_mask, 7)
    assert [(t, s) for t, _, s in got.images] == [("spectrum_0", 7)]
    (_, ref_img, _), (_, img, _) = ref.images[0], got.images[0]
    assert img.shape == ref_img.shape and img.dtype == np.uint8
    assert img.shape[0] == 3  # CHW for tensorboardX
    diff = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
    print(f"image: {np.count_nonzero(diff)} of {diff.size} values differ, "
          f"at most by {diff.max()}")
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size


def test_no_writer_does_no_work():
    # None stands where the spectra go: any work would raise
    assert vis.visualize_denoiser_batch(None, None, None, None, 0) is None
    _, pcfg = tiny_configs()
    assert vis.make_denoiser_visualize_hook(pcfg)(None, None, None, 0) is None


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("process", [0, 1])
def test_fit_calls_the_hook_every_visualize_frequency_steps(
        tmp_path, monkeypatch, process):
    """The hook's schedule: `fit` calls it the same way whatever the
    stage and whatever its train step does, so the step here hands the
    state back with a loss."""
    _, pcfg = tiny_configs()
    cfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, nr_epochs=1, batch_size=2, visualize_frequency=2))
    _, state = loop.init_detector_state(cfg, device="cpu")
    monkeypatch.setattr(distributed, "process_index", lambda: process)
    # no tensorboard writers (importing tensorboardX takes seconds): the
    # hook is called with whatever writer fit has, None here
    monkeypatch.setattr(fit_module, "_writers", lambda log_dir: (None, None))
    calls = []

    def hook(train_writer, st, batch, step):
        assert train_writer is None
        assert st is state and batch["clean"].shape == (2, CLIP)
        calls.append(step)

    steps = 4 if process == 0 else 2
    fit(cfg, state, TrainClock(), lambda st, batch: (st, {"loss": 0.5}),
        loop.make_detector_eval_step(cfg),
        _Batches([_batch(2, 10 + i) for i in range(steps)]), _Batches([]),
        str(tmp_path / "model"), str(tmp_path / "log"), visualize_hook=hook)
    assert calls == ([0, 2] if process == 0 else [])


def test_denoiser_hook_renders_in_eval_mode(monkeypatch):
    """`make_denoiser_visualize_hook`: the batch through the device stage
    and the model in eval mode, one image of `denoiser_batch_panels`'
    waveforms (the renderer stands in for `draw_spectrum`, which
    test_rendered_image_matches_sos_tpu holds against `sos_tpu`), the
    model's mode restored."""
    from sos_tpu_torch.utils import visualization

    _, pcfg = tiny_configs()
    _, state = loop.init_denoiser_state(pcfg, device="cpu")
    state.model.train()
    drawn = []

    def draw(waves, sr, titles):
        drawn.append((np.stack(waves), sr, tuple(titles)))
        return np.zeros((4, 5, 3), np.uint8)

    monkeypatch.setattr(visualization, "draw_spectrum", draw)
    writer, batch = RecordingWriter(), _batch(2, 10)
    vis.make_denoiser_visualize_hook(pcfg)(writer, state, batch, 6)
    assert [(t, s, img.shape) for t, img, s in writer.images] == [
        ("spectrum_0", 6, (3, 4, 5))]
    assert state.model.training
    want = vis.denoiser_batch_panels(pcfg, state.model, batch)
    assert state.model.training
    (waves, sr, titles), = drawn
    assert sr == pcfg.data.sample_rate and titles == vis.PANELS
    np.testing.assert_array_equal(
        waves, np.stack([want[k][0].numpy() for k in vis.PANELS]))
