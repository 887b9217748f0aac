"""Stage-1 silent-interval detector (port of `sos_tpu/models/detector.py`).

Dilated Conv2d blocks over the complex spectrogram, a 1x1 projection,
a channel-major flatten, nearest resampling of time onto the video-frame
grid, a BiLSTM and a 2-layer per-frame head. With per-row `valid_t` and
`valid_frames` `(B,)` (device tensors) it runs the exact length-bucketed
variant of `sos_tpu`: frames >= valid_t are zeroed at the input and
again after every trunk block, the frame grid is resampled from each
row's valid region, and the BiLSTM treats steps >= valid_frames as
padding.

Input : (B, F=256, T, 2) STFT real/imag, as in `sos_tpu`
Output: (B, num_frames) logits; sigmoid >= 0.5 means "voiced" (bit 1)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sos_tpu_torch.config import DetectorModelConfig
from sos_tpu_torch.models.layers import ConvBlock, TorchLinear, time_mask
from sos_tpu_torch.ops.lstm import BiLSTM
from sos_tpu_torch.ops.resize import nearest_resize_1d


class SilenceDetector(nn.Module):
    """`compute_dtype` runs the conv trunk in float32 or bfloat16; the
    BiLSTM and head stay float32. `bf16_head_proj` runs the LSTM input
    projection in bf16 (fp32 output)."""

    def __init__(self, cfg: DetectorModelConfig = DetectorModelConfig(),
                 compute_dtype: str = "float32", bf16_head_proj: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, compute_dtype)
        ch = cfg.in_channels
        self.trunk = []
        for i, (ks, dil) in enumerate(zip(cfg.kernel_sizes, cfg.dilations)):
            block = ConvBlock(ch, cfg.nf, ks, dil)
            self.add_module(f"conv{i}", block)  # sos_tpu's flax names
            self.trunk.append(block)
            ch = cfg.nf
        self.proj = ConvBlock(ch, cfg.outf, (1, 1))
        self.lstm = BiLSTM(cfg.outf * cfg.freq_bins, cfg.lstm_hidden,
                           bf16_proj=bf16_head_proj)
        self.fc1 = TorchLinear(2 * cfg.lstm_hidden, cfg.fc_hidden)
        self.fc2 = TorchLinear(cfg.fc_hidden, 1)

    def forward(self, spec: torch.Tensor, num_frames: Optional[int] = None,
                valid_t: Optional[torch.Tensor] = None,
                valid_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """spec: (B, F, T, 2) -> logits (B, num_frames)."""
        return self.forward_nchw(spec.permute(0, 3, 1, 2), num_frames,
                                 valid_t, valid_frames)

    def forward_nchw(self, x: torch.Tensor, num_frames: Optional[int] = None,
                     valid_t: Optional[torch.Tensor] = None,
                     valid_frames: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """x: (B, 2, F, T) -> logits (B, num_frames). `valid_t`,
        `valid_frames`: `(B,)` integer tensors on x's device (the
        length-bucketed variant; `valid_frames` defaults to num_frames)."""
        out_frames = num_frames or self.cfg.num_frames
        x = x.to(self.dtype)
        tmask = None
        if valid_t is not None:
            tmask = time_mask(x, valid_t)
            x = x * tmask
        for block in self.trunk:
            x = block(x)
            if tmask is not None:
                # BN makes the padding frames nonzero; re-zero them so the
                # next SAME conv sees the unpadded program's zero padding
                x = x * tmask
        x = self.proj(x)  # (B, C, F, T)
        # channel-major flatten (c*F + f), like the reference's
        # view(B, C*F, T) (m1 networks.py:132), then time onto the
        # video-frame grid with torch-nearest indices (networks.py:133)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t).transpose(1, 2)  # (B, T, C*F)
        if valid_t is None:
            x = nearest_resize_1d(x, out_frames, dim=1).float()
        else:
            # floor(j * valid_t / valid_frames) per row, in integers
            vf = out_frames if valid_frames is None else valid_frames
            vf = torch.as_tensor(vf, device=x.device).expand(b)
            j = torch.arange(out_frames, device=x.device)
            idx = torch.clamp((j[None, :] * valid_t[:, None]) // vf[:, None],
                              0, t - 1)
            x = torch.gather(x, 1, idx[:, :, None].expand(b, out_frames,
                                                           c * f)).float()
        x = self.lstm(x, valid_len=valid_frames)  # (B, frames, 2H)
        x = torch.relu(self.fc1(x))
        return self.fc2(x)[..., 0]
