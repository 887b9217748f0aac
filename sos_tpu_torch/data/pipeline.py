"""Host batchers + device-side mixing/STFT stages of training (port of
`sos_tpu/data/pipeline.py`).

The split is `sos_tpu`'s:

* **host** (the batchers): decode WAVs once (cached), slice raw clip
  windows, pick noise crops and SNRs — indexing only, no DSP. The same
  seed gives `sos_tpu`'s batches, item for item;
* **device** (`device_mix_and_stft_*`): the silence gate, the SNR mix,
  the STFTs and the ground-truth cRM at the start of each train step, on
  the card: the clean signal gated by `1 - mask` and the mixture by
  `mask` in kernel K2 (its complement instance and its plain one), the
  STFTs in kernel K1 (the denoiser's four in one launch).

Batch layouts (numpy from the batchers, tensors on the device):
  detector:  clean (B, 28000), noise (B, 28000), snr (B,), bits (B, 60)
  denoiser:  clean (B, 28000), noise (B, 28000), snr (B,), bits (B, 60)

The WAV cache decodes through the C++ engine (`runtime/`) when its
library builds, as `sos_tpu`'s does, with `dsp/audio_io.load` as the
fallback, and bulk-decodes each batch's cache misses on the engine's
threads.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from sos_tpu_torch.config import DataConfig, StftConfig
from sos_tpu_torch.data.sampling import NoiseBank
from sos_tpu_torch.data.windows import DenoiserWindow, DetectorWindow
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.crm import compressed_crm
from sos_tpu_torch.dsp.mixing import mask_gate, mix_at_snr
from sos_tpu_torch.dsp.stft import stft as stft_fn


# ---------------------------------------------------------------------------
# Device-side stages (the first part of each train step)
# ---------------------------------------------------------------------------


def _silenced(clean: torch.Tensor, bits: torch.Tensor,
              data_cfg: DataConfig) -> torch.Tensor:
    """`clean * (1 - mask)`: truly silent intervals (K2's complement)."""
    ratio = data_cfg.sample_rate / data_cfg.frame_rate
    return mask_gate(clean, bits, ratio, data_cfg.despeckle_min_run,
                     complement=True)


def device_mix_and_stft_detector(
    clean: torch.Tensor,   # (B, L) raw clean clips
    noise: torch.Tensor,   # (B, L) noise crops
    snr_db: torch.Tensor,  # (B,)
    bits: torch.Tensor,    # (B, frames) 0=silent 1=voiced
    data_cfg: DataConfig = DataConfig(),
    stft_cfg: StftConfig = StftConfig(),
) -> Dict[str, torch.Tensor]:
    """Silence-gate -> mix at SNR -> STFT (m1 dataset recipe)."""
    clean = _silenced(clean, bits, data_cfg)
    mixed, _, _ = mix_at_snr(clean, noise, snr_db, norm=data_cfg.mix_norm)
    spec = stft_fn(mixed, stft_cfg.n_fft, stft_cfg.hop_length,
                   stft_cfg.win_length)
    return {"audio": spec, "label": bits.float()}


def device_mix_and_stft_denoiser(
    clean: torch.Tensor,
    noise: torch.Tensor,
    snr_db: torch.Tensor,
    bits: torch.Tensor,
    data_cfg: DataConfig = DataConfig(),
    stft_cfg: StftConfig = StftConfig(),
) -> Dict[str, torch.Tensor]:
    """m2 dataset recipe: four STFTs (one K1 launch over the stacked
    signals) + the ground-truth compressed cRM."""
    ratio = data_cfg.sample_rate / data_cfg.frame_rate
    clean = _silenced(clean, bits, data_cfg)
    mixed, clean_sig, full_noise = mix_at_snr(clean, noise, snr_db,
                                              norm=data_cfg.mix_norm)
    gated = mask_gate(mixed, bits, ratio, data_cfg.despeckle_min_run)
    specs = stft_fn(torch.stack([mixed, clean_sig, gated, full_noise]),
                    stft_cfg.n_fft, stft_cfg.hop_length, stft_cfg.win_length)
    mixed_stft, clean_stft, gated_stft, full_noise_stft = specs.unbind(0)
    return {
        "mixed": mixed_stft,
        "clean": clean_stft,
        "noise": gated_stft,
        "full_noise": full_noise_stft,
        "mask": compressed_crm(clean_stft, mixed_stft),
    }


# ---------------------------------------------------------------------------
# Host batchers
# ---------------------------------------------------------------------------


class _WavCache:
    """LRU decode-once cache of waveforms at the processing sample rate.

    Eviction is least-recently-USED (hits refresh recency), so a corpus
    larger than `capacity` keeps its hot set resident instead of
    cycling.

    Decode+resample run through the C++ engine (`sos_tpu_torch.runtime`)
    when its library builds, else through `dsp/audio_io.load`.
    `prefetch_paths` bulk-decodes a batch's cache misses with the
    engine's threaded `load_batch`."""

    def __init__(self, sample_rate: int, capacity: int = 2048):
        from sos_tpu_torch.runtime import NativeAudioEngine, native_available

        self.sample_rate = sample_rate
        self.capacity = capacity
        self._store: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._engine = NativeAudioEngine() if native_available() else None

    def _put(self, path: str, wav: np.ndarray) -> None:
        if self.capacity <= 0:
            return  # caching disabled: every get() decodes
        while len(self._store) >= self.capacity:
            self._store.popitem(last=False)
        self._store[path] = wav

    def get(self, path: str) -> np.ndarray:
        hit = self._store.get(path)
        if hit is not None:
            self._store.move_to_end(path)
            return hit
        if self._engine is not None:
            wav, _ = self._engine.load(path, sr=self.sample_rate)
        else:
            wav, _ = audio_io.load(path, sr=self.sample_rate)
        self._put(path, wav)
        return wav

    def prefetch_paths(self, paths) -> None:
        """Decode all cache misses among `paths` in one threaded native
        call (no-op without the native engine: `get` then decodes each
        path in turn)."""
        missing = [p for p in dict.fromkeys(paths) if p not in self._store]
        if self._engine is None or len(missing) < 2:
            return
        from sos_tpu_torch.runtime import resampled_length

        max_out = 0
        for p in missing:
            try:
                n, native_sr = self._engine.info(p)
            except OSError:
                return  # get() surfaces the error per file
            max_out = max(max_out,
                          resampled_length(n, native_sr, self.sample_rate))
        if max_out == 0:
            return
        buf, lengths = self._engine.load_batch(missing, self.sample_rate,
                                               max_out)
        for i, p in enumerate(missing):
            self._put(p, buf[i, : lengths[i]].copy())


class _BatcherBase:
    def __init__(
        self,
        windows: Sequence,
        noise_bank: NoiseBank,
        data_cfg: DataConfig,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
    ):
        self.windows = list(windows)
        self.noise = noise_bank
        self.cfg = data_cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.cache = _WavCache(data_cfg.sample_rate,
                               capacity=data_cfg.wav_cache_capacity)
        self.epoch = 0
        # The device mask is built with the CONFIGURED frame rate (one
        # frame->sample geometry per clip length); a file whose own
        # framerate differs would have its labels/mask silently
        # misaligned against the audio the host sliced with the per-file
        # rate. The eval chain honours per-file framerates; training
        # requires the canonical one.
        bad = sorted({w.framerate for w in self.windows
                      if abs(w.framerate - data_cfg.frame_rate) > 1e-9})
        if bad:
            raise ValueError(
                f"training windows carry framerates {bad} but the device "
                f"mix/STFT stage is built for frame_rate="
                f"{data_cfg.frame_rate}; re-encode the dataset at the "
                "configured rate (or change data.frame_rate)")

    def __len__(self) -> int:
        # fixed-shape batches only: the epoch-order resume assumes every
        # batch has exactly batch_size items, so the remainder is dropped
        return len(self.windows) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def shard(self, host_id: int, num_hosts: int) -> "_BatcherBase":
        """Per-host window sharding: host k keeps windows [k::num_hosts]
        (before the per-epoch shuffle), truncated so every host holds the
        same count, and a per-host seed (`seed * num_hosts + host_id`) so
        the hosts' noise and SNR draws differ. Returns self."""
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        keep = len(self.windows) // num_hosts
        self.windows = self.windows[host_id::num_hosts][:keep]
        self.seed = self.seed * num_hosts + host_id
        return self

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.windows))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _clip_samples(self) -> int:
        raise NotImplementedError

    def _clean_clip(self, w) -> np.ndarray:
        raise NotImplementedError

    def _bits(self, w) -> np.ndarray:
        raise NotImplementedError

    def _draw_noise(self, rng, length: int):
        """One item's noise/SNR draws — factored out so `iter_from` can
        replay the exact rng stream of skipped batches without touching
        the waveform cache."""
        track = self.noise.random_track(rng)
        start = int(rng.integers(0, max(1, len(track) - length + 1)))
        crop = track[start:start + length]
        if self.cfg.snr_idx is None:
            snr = self.cfg.snrs[int(rng.integers(0, len(self.cfg.snrs)))]
        else:
            snr = self.cfg.snrs[self.cfg.snr_idx]
        return crop, snr

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate the epoch's deterministic batch order from batch
        `start_batch` (exact mid-epoch resume). The skipped prefix replays
        only the per-item rng draws — the same stream as a full epoch —
        and decodes no audio."""
        rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        order = self._order()
        length = self._clip_samples()
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if b < start_batch:
                for _ in sel:
                    self._draw_noise(rng, length)
                continue
            # bulk-decode this batch's cache misses (threaded C++ engine)
            self.cache.prefetch_paths(
                [self.windows[wi].audio_path for wi in sel])
            clean = np.zeros((len(sel), length), dtype=np.float32)
            noise = np.zeros((len(sel), length), dtype=np.float32)
            snr = np.zeros((len(sel),), dtype=np.float32)
            bits = np.zeros((len(sel), self.cfg.clip_frames), dtype=np.float32)
            for j, wi in enumerate(sel):
                w = self.windows[wi]
                clip = self._clean_clip(w)
                clean[j, :len(clip)] = clip[:length]
                crop, snr[j] = self._draw_noise(rng, length)
                noise[j, :len(crop)] = crop
                wb = self._bits(w)
                bits[j, :len(wb)] = wb[:self.cfg.clip_frames]
            yield {"clean": clean, "noise": noise, "snr": snr, "bits": bits}


class DetectorBatcher(_BatcherBase):
    """Batches of raw detector clips (m1 dataset windows: 60 video frames)."""

    def _clip_samples(self) -> int:
        return int(self.cfg.clip_frames / self.cfg.frame_rate * self.cfg.sample_rate)

    def _clean_clip(self, w: DetectorWindow) -> np.ndarray:
        snd = self.cache.get(w.audio_path)
        sr = self.cfg.sample_rate
        a = int(w.start_frame / w.framerate * sr)
        b = int((w.start_frame + self.cfg.clip_frames) / w.framerate * sr)
        return snd[a:b]

    def _bits(self, w: DetectorWindow) -> np.ndarray:
        return np.asarray(w.bits, dtype=np.float32)


class DenoiserBatcher(_BatcherBase):
    """Batches of raw 2 s denoiser clips (m2 dataset windows)."""

    def _clip_samples(self) -> int:
        return self.cfg.clip_seconds * self.cfg.sample_rate

    def _clean_clip(self, w: DenoiserWindow) -> np.ndarray:
        snd = self.cache.get(w.audio_path)
        sr = self.cfg.sample_rate
        return snd[int(w.start_sec * sr):int(w.end_sec * sr)]

    def _bits(self, w: DenoiserWindow) -> np.ndarray:
        return np.asarray([1.0 if c == "1" else 0.0 for c in w.bits],
                          dtype=np.float32)
