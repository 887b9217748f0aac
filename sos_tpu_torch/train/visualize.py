"""Training-time visualization: tensorboard spectrogram panels (port of
`sos_tpu/train/visualize.py`).

Equivalent of the reference's `MyAgent.visualize_batch`
(m2 agent.py:206-233): every `visualize_frequency` steps, render the
mixed / gated-noise / full-noise / predicted-noise / clean / denoised
sextet as stacked spectrograms and log the image to tensorboard.

The device part, `denoiser_panel_waves`, returns the six panel
waveforms on the spectra's device: `denoised` is kernel K3 (`crm_istft`)
on the packed cRM and mixed STFT, the same function as
`apply_compressed_crm` followed by `istft`; the other five go through
`istft`. `denoiser_batch_panels` runs a training batch through the
device stage and the model to those waveforms. `visualize_denoiser_batch`
renders them with `utils/visualization.py` `draw_spectrum` (which
imports matplotlib) and writes `writer.add_image`.
`make_denoiser_visualize_hook` builds the hook `train/fit.py`
`fit(visualize_hook=...)` calls; like `sos_tpu`, no train CLI passes
one.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig, StftConfig
from sos_tpu_torch.dsp.stft import crm_istft, istft
from sos_tpu_torch.models.layers import exact_fp32

PANELS = ("noisy_input", "noise_intervals", "gt_full_noise",
          "pred_full_noise", "gt_clean", "denoised")


def _packed(spec: torch.Tensor) -> torch.Tensor:
    """`(B, F, T, 2)` -> the packed `(B, T, 2F)` = [re | im] K3 reads."""
    return torch.cat([spec[..., 0], spec[..., 1]], dim=1).transpose(1, 2)


@torch.no_grad()
def denoiser_panel_waves(prepared: Dict, noise_pred: torch.Tensor,
                         mask: torch.Tensor, n: int = 1,
                         stft_cfg: StftConfig = StftConfig()
                         ) -> Dict[str, torch.Tensor]:
    """The six panels' waveforms `(n, L)` of the first `n` items, in
    `PANELS` order. `prepared` is `device_mix_and_stft_denoiser`'s dict;
    `noise_pred` and `mask` (the compressed cRM) the model's outputs, all
    `(B, F, T, 2)`."""
    geometry = (stft_cfg.n_fft, stft_cfg.hop_length, stft_cfg.win_length)
    spectra = (prepared["mixed"], prepared["noise"], prepared["full_noise"],
               noise_pred, prepared["clean"])
    waves = {name: istft(spec[:n].detach(), *geometry)
             for name, spec in zip(PANELS, spectra)}
    waves["denoised"] = crm_istft(_packed(mask[:n].detach().float()),
                                  _packed(prepared["mixed"][:n].float()),
                                  *geometry)
    return waves


def _write_panels(writer, waves: Dict[str, torch.Tensor], step: int,
                  sr: int, n: int) -> None:
    """Render the first `n` items' panels and write them to `writer`."""
    from sos_tpu_torch.utils.visualization import draw_spectrum

    waves = {k: np.asarray(v.cpu()) for k, v in waves.items()}
    for i in range(n):
        img = draw_spectrum([waves[k][i] for k in PANELS], sr=sr,
                            titles=list(PANELS))
        # (H, W, BGR) -> CHW RGB for tensorboardX
        writer.add_image(f"spectrum_{i}", img.transpose(2, 0, 1)[::-1],
                         global_step=step)


def visualize_denoiser_batch(writer, prepared: Dict, noise_pred, mask,
                             step: int, sr: int = 14000, n: int = 1,
                             stft_cfg: StftConfig = StftConfig()) -> None:
    """Log spectrogram panels for the first `n` items of a batch.

    `prepared` is the device_mix_and_stft_denoiser output dict; noise_pred
    and mask are the model outputs (all (B, F, T, 2)); `stft_cfg` their
    STFT geometry."""
    if writer is None:
        return
    _write_panels(writer, denoiser_panel_waves(prepared, noise_pred, mask, n,
                                               stft_cfg), step, sr, n)


def denoiser_batch_panels(cfg: ExperimentConfig, model, batch: Dict,
                          n: int = 1) -> Dict[str, torch.Tensor]:
    """A training batch's six panel waveforms `(n, L)` on the model's
    device: the batch through the device stage and the model in eval mode
    (no gradient, full fp32), then `denoiser_panel_waves` at `cfg.stft`;
    the model's mode is restored."""
    from sos_tpu_torch.train.loop import denoiser_inputs

    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), exact_fp32():
            prepared = denoiser_inputs(cfg, batch, device)
            noise_pred, mask = model(prepared["mixed"], prepared["noise"])
            return denoiser_panel_waves(prepared, noise_pred, mask, n,
                                        cfg.stft)
    finally:
        model.train(was_training)


def make_denoiser_visualize_hook(cfg: ExperimentConfig,
                                 n: int = 1) -> Callable:
    """`fit`'s `visualize_hook` for the denoiser: `denoiser_batch_panels`
    on the step's batch, rendered and written to the train writer."""

    def hook(writer, state, batch, step: int) -> None:
        if writer is None:
            return
        _write_panels(writer, denoiser_batch_panels(cfg, state.model, batch,
                                                    n),
                      step, cfg.data.sample_rate, n)

    return hook
