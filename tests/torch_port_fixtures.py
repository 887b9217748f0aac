"""Shared set-up for the `sos_tpu_torch` parity tests (tests/test_torch_*.py).

Weights reach both packages the same way: random torch oracle networks
(tests/torch_oracles.py) -> `sos_tpu.models.torch_import.*_torch_to_flax`
-> flax trees of numpy arrays, which `sos_tpu` runs directly and
`sos_tpu_torch.models.convert.*_from_jax` turns into the port's
state_dicts. So the port's converter is part of what every model test
checks.

Widths are small (two conv blocks, nf 4-8, H 4-8, inpaint (4, 6, 8));
clips are the real 28000 samples, so T = 178 and the InpaintNet resize
fixups fire as on the main path.
"""

import numpy as np
import torch

from sos_tpu.config import (DataConfig, DenoiserModelConfig,
                            DetectorModelConfig, ExperimentConfig)
from sos_tpu.models.torch_import import (denoiser_torch_to_flax,
                                         detector_torch_to_flax)
from sos_tpu_torch.config import ExperimentConfig as PortExperimentConfig
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax

from tests.torch_oracles import DetectorOracle, JointOracle, randomize_bn_stats

CLIP = 28000
SPECS = (((1, 7), (1, 1)), ((5, 5), (2, 2)))


def tiny_configs():
    """The same small experiment as sos_tpu's and as the port's config
    (the port's is parsed from sos_tpu's JSON)."""
    ks = tuple(s[0] for s in SPECS)
    dils = tuple(s[1] for s in SPECS)
    det = DetectorModelConfig(nf=4, outf=2, kernel_sizes=ks, dilations=dils,
                              lstm_hidden=4, fc_hidden=4)
    den = DenoiserModelConfig(nf_mixed=8, nf_noise=4, outf_mixed=8,
                              outf_noise=4, kernel_sizes=ks, dilations=dils,
                              lstm_hidden=8, fc_hidden=16,
                              inpaint_ch=(4, 6, 8))
    cfg = ExperimentConfig(detector=det, denoiser=den, data=DataConfig())
    return cfg, PortExperimentConfig.from_json(cfg.to_json())


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def oracle_variables(cfg, seed: int = 0):
    """(detector, denoiser) flax variables from seeded torch oracles."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed + 100)
    d, n = cfg.detector, cfg.denoiser
    det = DetectorOracle(SPECS, freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                         hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
    den = JointOracle(SPECS, freq_bins=n.freq_bins, ch=n.inpaint_ch,
                      nf=n.nf_mixed, hidden=n.lstm_hidden,
                      fc_hidden=n.fc_hidden)
    with torch.no_grad():
        randomize_bn_stats(det, gen)
        randomize_bn_stats(den, gen)
    return (detector_torch_to_flax(_np_state(det)),
            denoiser_torch_to_flax(_np_state(den)))


def port_states(det_vars, den_vars):
    return detector_from_jax(det_vars), denoiser_from_jax(den_vars)


def make_clips(n: int, seed: int) -> np.ndarray:
    """Tone bursts with silent gaps plus noise, float32 (n, 28000)."""
    rng = np.random.default_rng(seed)
    t = np.arange(CLIP) / 14000.0
    bursts = np.sin(2 * np.pi * 220.0 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    noise = rng.standard_normal((n, CLIP)) * 0.05
    return (0.4 * bursts + noise).astype(np.float32)


def training_corpus(root, durations=(4.0, 5.0, 4.5), seed: int = 41,
                    sr: int = 14000):
    """A tiny training corpus under `root` (a pathlib.Path): clip WAVs of
    alternating 0.5 s bursts and silences with their bitstreams in a
    dataset JSON (`ds.json`), and two 5 s noise WAVs in `noise/`.
    Returns (dataset JSON path, noise dir)."""
    import json

    from sos_tpu_torch.dsp import audio_io

    rng = np.random.default_rng(seed)
    (root / "clips").mkdir(parents=True, exist_ok=True)
    (root / "noise").mkdir(exist_ok=True)
    files = []
    for i, dur in enumerate(durations):
        n = int(dur * sr)
        y = np.zeros(n, np.float32)
        for s in range(0, n, sr):
            y[s:s + sr // 2] = rng.standard_normal(
                min(sr // 2, n - s)).astype(np.float32) * 0.3
        path = str(root / "clips" / f"c{i}.wav")
        audio_io.write_wav(path, y, sr)
        frames = int(dur * 30)
        files.append({
            "path": path, "audio_path": path, "framerate": 30,
            "audio_sample_rate": sr, "audio_samples": n, "duration": dur,
            "num_frames": frames, "bit_stream": "".join(
                "1" if (j // 15) % 2 == 0 else "0" for j in range(frames))})
    ds_json = root / "ds.json"
    ds_json.write_text(json.dumps({"dataset_path": str(root / "clips"),
                                   "num_videos": len(files), "files": files}))
    for i in range(2):
        audio_io.write_wav(str(root / "noise" / f"n{i}.wav"),
                           (rng.standard_normal(sr * 5) * 0.2)
                           .astype(np.float32), sr)
    return str(ds_json), str(root / "noise")
