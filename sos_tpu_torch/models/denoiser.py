"""Stage-2 joint denoiser (port of `sos_tpu/models/denoiser.py`).

* :class:`InpaintNet`: dual-encoder U-Net that inpaints the full noise
  spectrogram from the silence-gated observation and the mixed signal.
* :class:`ContextAggNet`: two dilated-conv encoders, a BiLSTM over time
  and an MLP head with a sigmoid giving the compressed cRM.
* :class:`JointDenoiser`: `noise = inpaint(gated, mixed)`, then
  `mask = context(mixed, noise)`.

Each module also runs `sos_tpu`'s exact length-bucketed variant, given
per-row valid frame counts `valid_t` `(B,)` (device tensors): every
InpaintNet block re-zeroes its time tail and reflects at each row's own
boundary, with the valid widths chained through the U-Net and the two
skip resizes done per row (`dynamic_nearest_time`); the ContextAggNet
encoders re-zero frames >= valid_t after every block and the BiLSTM
treats them as padding. Outputs past a row's valid_t are to be masked
by the caller (the iSTFT's `valid_t` does it).

Training: `model.train()` puts the BatchNorms on batch statistics;
`remat=True` rematerialises, as `sos_tpu`'s `remat` does, every
InpaintNet `DownConvBlock` (not the two `UpConvBlock`s) and every
ContextAggNet encoder block in the backward pass.

Public `forward`s take and return `sos_tpu`'s (B, F, T, 2); the
pipelines use `forward_packed`, which takes NCHW and returns the head's
packed (B, T, 2F) output that kernel K3 reads without a transpose.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sos_tpu_torch.config import DenoiserModelConfig
from sos_tpu_torch.models.layers import (ConvBlock, DownConvBlock,
                                         TorchLinear, UpConvBlock,
                                         remat_call, time_mask)
from sos_tpu_torch.ops.lstm import BiLSTM
from sos_tpu_torch.ops.resize import (dynamic_nearest_time,
                                      nearest_resize_1d, nearest_resize_2d)


def _to_nchw(spec: torch.Tensor) -> torch.Tensor:
    return spec.permute(0, 3, 1, 2)


class InpaintNet(nn.Module):
    """Noise-spectrogram inpainting U-Net (m2 networks.py:152-205)."""

    def __init__(self, channels: Tuple[int, int, int] = (64, 128, 256),
                 compute_dtype: str = "float32", remat: bool = False):
        super().__init__()
        self.dtype = getattr(torch, compute_dtype)
        self.remat = remat
        ch1, ch2, ch3 = channels
        # encoder A: silence-gated noise observation
        self.a_in = DownConvBlock(2, ch1, 5, 1)
        self.a_d1 = DownConvBlock(ch1, ch2, 5, 2)
        self.a_d2 = DownConvBlock(ch2, ch2, 5, 1)
        # encoder B: mixed signal
        self.b_in = DownConvBlock(2, ch1, 5, 1)
        self.b_d1 = DownConvBlock(ch1, ch2, 5, 2)
        self.b_d2 = DownConvBlock(ch2, ch2, 5, 1)
        self.mid0 = DownConvBlock(2 * ch2, ch3, 3, 2)
        self.mid1 = DownConvBlock(ch3, ch3, 3, 1)
        self.mid_dil2 = DownConvBlock(ch3, ch3, 3, 1, 2)
        self.mid_dil4 = DownConvBlock(ch3, ch3, 3, 1, 4)
        self.mid_dil8 = DownConvBlock(ch3, ch3, 3, 1, 8)
        self.mid_dil16 = DownConvBlock(ch3, ch3, 3, 1, 16)
        self.mid2 = DownConvBlock(ch3, ch3, 3, 1)
        self.mid3 = DownConvBlock(ch3, ch3, 3, 1)
        self.mid_up = UpConvBlock(ch3, ch2, 3, 2)
        self.up1_conv = DownConvBlock(2 * ch2, ch2, 3, 1)
        self.up1_up = UpConvBlock(ch2, ch1, 3, 2)
        self.up2_conv = DownConvBlock(2 * ch1, ch1, 3, 1)
        self.out = DownConvBlock(ch1, 2, 3, 1, final=True)

    def forward(self, gated_noise: torch.Tensor, mixed: torch.Tensor,
                valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW (B, 2, F, T) inputs -> predicted noise (B, 2, F, T) float32;
        `valid_t` `(B,)` runs the length-bucketed variant."""
        if valid_t is not None:
            return self._forward_valid(gated_noise, mixed, valid_t)

        def down(block, x):
            return remat_call(block, self.remat, x)
        down1 = down(self.a_in, gated_noise.to(self.dtype))
        down2 = down(self.a_d2, down(self.a_d1, down1))
        down3 = down(self.b_in, mixed.to(self.dtype))
        down4 = down(self.b_d2, down(self.b_d1, down3))
        x = torch.cat([down2, down4], dim=1)
        for block in (self.mid0, self.mid1, self.mid_dil2, self.mid_dil4,
                      self.mid_dil8, self.mid_dil16, self.mid2, self.mid3):
            x = down(block, x)
        x = self.mid_up(x)
        if x.shape[2:] != down4.shape[2:]:
            x = nearest_resize_2d(x, down4.shape[2:], 2, 3)
        x = self.up1_up(down(self.up1_conv, torch.cat([x, down4], dim=1)))
        if x.shape[2:] != down3.shape[2:]:
            x = nearest_resize_2d(x, down3.shape[2:], 2, 3)
        x = down(self.out, down(self.up2_conv, torch.cat([x, down3], dim=1)))
        return x.float()

    def _forward_valid(self, gated_noise: torch.Tensor, mixed: torch.Tensor,
                       v0: torch.Tensor) -> torch.Tensor:
        """The valid-width chain of sos_tpu's InpaintNet: each block
        returns its output's per-row valid width, which the next takes."""
        down1, v = self.a_in(gated_noise.to(self.dtype), v0)
        x, v2 = self.a_d1(down1, v)
        down2, v2 = self.a_d2(x, v2)
        down3, v3b = self.b_in(mixed.to(self.dtype), v0)
        x, v4 = self.b_d1(down3, v3b)
        down4, v4 = self.b_d2(x, v4)
        x, vm = self.mid0(torch.cat([down2, down4], dim=1), v4)
        for block in (self.mid1, self.mid_dil2, self.mid_dil4, self.mid_dil8,
                      self.mid_dil16, self.mid2, self.mid3, self.mid_up):
            x, vm = block(x, vm)
        # the frequency widths always differ here; time resizes each
        # row's valid region onto the skip's
        x = nearest_resize_1d(x, down4.shape[2], dim=2)
        x = dynamic_nearest_time(x, vm, v4, down4.shape[3])
        x, vu = self.up1_conv(torch.cat([x, down4], dim=1), v4)
        x, vu = self.up1_up(x, vu)
        x = nearest_resize_1d(x, down3.shape[2], dim=2)
        x = dynamic_nearest_time(x, vu, v3b, down3.shape[3])
        x, vf = self.up2_conv(torch.cat([x, down3], dim=1), v3b)
        x, _ = self.out(x, vf)
        return x.float()


class ContextAggNet(nn.Module):
    """Mask predictor over mixed + predicted-noise spectrograms (m2 networks.py:54-94)."""

    def __init__(self, cfg: DenoiserModelConfig = DenoiserModelConfig(),
                 compute_dtype: str = "float32", bf16_head_proj: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, compute_dtype)
        self.remat = remat
        self.enc_x = self._encoder(cfg.nf_mixed, cfg.outf_mixed, "enc_x")
        self.enc_n = self._encoder(cfg.nf_noise, cfg.outf_noise, "enc_n")
        self.lstm = BiLSTM((cfg.outf_mixed + cfg.outf_noise) * cfg.freq_bins,
                           cfg.lstm_hidden, bf16_proj=bf16_head_proj)
        self.fc0 = TorchLinear(2 * cfg.lstm_hidden, cfg.fc_hidden)
        self.fc1 = TorchLinear(cfg.fc_hidden, cfg.fc_hidden)
        self.fc2 = TorchLinear(cfg.fc_hidden, 2 * cfg.freq_bins)

    def _encoder(self, nf: int, outf: int, prefix: str):
        cfg, ch, blocks = self.cfg, 2, []
        for i, (ks, dil) in enumerate(zip(cfg.kernel_sizes, cfg.dilations)):
            blocks.append(ConvBlock(ch, nf, ks, dil))
            self.add_module(f"{prefix}{i}", blocks[-1])  # sos_tpu's flax names
            ch = nf
        blocks.append(ConvBlock(ch, outf, (1, 1)))
        self.add_module(f"{prefix}proj", blocks[-1])
        return blocks

    def _encode(self, x: torch.Tensor, blocks,
                valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        tmask = None
        if valid_t is not None:
            tmask = time_mask(x, valid_t)
            x = x * tmask
        for block in blocks[:-1]:
            x = remat_call(block, self.remat, x)
            if tmask is not None:
                x = x * tmask  # keep SAME padding == the unpadded program
        x = remat_call(blocks[-1], self.remat, x)  # the 1x1 projection
        b, c, f, t = x.shape  # channel-major flatten -> (B, T, C*F)
        return x.reshape(b, c * f, t).transpose(1, 2).float()

    def forward_packed(self, mixed: torch.Tensor, noise_pred: torch.Tensor,
                       valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW inputs -> sigmoid head output (B, T, 2F), packed
        [re-channel | im-channel] like the reference's view(B, 2, F, T).
        `valid_t` `(B,)` runs the length-bucketed variant."""
        h = torch.cat([self._encode(mixed, self.enc_x, valid_t),
                       self._encode(noise_pred, self.enc_n, valid_t)], dim=-1)
        h = self.lstm(h, valid_len=valid_t)  # (B, T, 2H)
        h = torch.relu(self.fc0(h))
        h = torch.relu(self.fc1(h))
        return torch.sigmoid(self.fc2(h))

    def forward(self, mixed: torch.Tensor, noise_pred: torch.Tensor,
                valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, F, T, 2) inputs -> compressed cRM (B, F, T, 2)."""
        h = self.forward_packed(_to_nchw(mixed), _to_nchw(noise_pred),
                                valid_t)
        b, t, _ = h.shape
        return h.reshape(b, t, 2, self.cfg.freq_bins).permute(0, 3, 1, 2)


class JointDenoiser(nn.Module):
    """InpaintNet -> ContextAggNet (m2 networks.py:208-217)."""

    def __init__(self, cfg: DenoiserModelConfig = DenoiserModelConfig(),
                 compute_dtype: str = "float32", bf16_head_proj: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.inpaint = InpaintNet(cfg.inpaint_ch, compute_dtype, remat)
        self.context = ContextAggNet(cfg, compute_dtype, bf16_head_proj,
                                     remat)

    def forward_packed(self, mixed: torch.Tensor, gated_noise: torch.Tensor,
                       valid_t: Optional[torch.Tensor] = None):
        """NCHW inputs -> (noise_pred NCHW, packed cRM (B, T, 2F)).
        With `valid_t` `(B,)`, both are valid below each row's valid_t
        only."""
        noise_pred = self.inpaint(gated_noise, mixed, valid_t)
        return noise_pred, self.context.forward_packed(mixed, noise_pred,
                                                       valid_t)

    def forward(self, mixed: torch.Tensor, gated_noise: torch.Tensor,
                valid_t: Optional[torch.Tensor] = None):
        """(B, F, T, 2) inputs -> (noise_pred, compressed_crm), both (B, F, T, 2)."""
        noise_pred, h = self.forward_packed(_to_nchw(mixed),
                                            _to_nchw(gated_noise), valid_t)
        b, t, _ = h.shape
        crm = h.reshape(b, t, 2, self.cfg.freq_bins).permute(0, 3, 1, 2)
        return noise_pred.permute(0, 2, 3, 1), crm
