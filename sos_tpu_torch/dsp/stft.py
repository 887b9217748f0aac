"""librosa-convention STFT / iSTFT (port of `sos_tpu/dsp/stft.py`).

Reference behaviour (`librosa.stft(y, n_fft=510, hop_length=158,
win_length=400)`, center=True reflect padding, a periodic Hann window
zero-padded to n_fft, and the matching `librosa.istft`) is reproduced as
dense DFT matmuls with the same float64-built matrices as `sos_tpu`.

Two kernels live here:

* K1 `stft_cat`: framing + windowed real DFT, `(B, L)` -> packed
  `(B, T, 2F)` = [re | im] (`csrc/stft.cu`), centered (reflect at the
  clip's ends) or, with `center=False`, over a buffer the caller has
  already padded, as the length-bucketed predictors do;
* K3 `crm_istft`: cRM recover + complex multiply + iSTFT, packed cRM and
  packed mixed STFT -> waveform (`csrc/crm_istft.cu`), optionally with a
  per-row count of valid frames `valid_t` `(B,)`: row b drops frames >=
  valid_t[b] and divides by the window-square envelope of its valid
  frames only (`sos_tpu`'s `istft(valid_t=)`, vmapped over rows).

Both kernels compute the 510-point real DFT as a 255-point complex
prime-factor FFT (3 * 5 * 17, `csrc/pfa.cuh`) from the tables that
`pfa_tables` builds here in float64; they take only the geometry of every
config (n_fft 510, hop 158, win 400). Each wrapper runs its plain PyTorch
version (`*_plain`, the dense DFT matmuls) on a CPU tensor and launches
its kernel on a CUDA tensor. The plain products run in full fp32
(`sos_tpu` uses Precision.HIGHEST): callers on the card keep
`torch.backends.cuda.matmul.allow_tf32` False.

Layout convention of the public functions: spectrograms `(..., F, T, 2)`
as in `sos_tpu`; the packed form is `(..., T, 2F)`.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sos_tpu_torch.config import HOP_LENGTH, N_FFT, WIN_LENGTH
from sos_tpu_torch.dsp.crm import crm_sigmoid_recover
from sos_tpu_torch.kernels import aligned16, launch, on_device


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, == scipy.get_window('hann', n)."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(n_fft: int = N_FFT, win_length: int = WIN_LENGTH) -> np.ndarray:
    """Hann(win_length) centered inside n_fft zeros (librosa util.pad_center)."""
    w = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad:lpad + win_length] = w
    return out


@functools.lru_cache(maxsize=8)
def _analysis_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2*bins) real matrix: windowed frame -> [real bins | imag bins]."""
    bins = n_fft // 2 + 1
    w = padded_window(n_fft, win_length)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    a_re = w[:, None] * np.cos(ang)
    a_im = -w[:, None] * np.sin(ang)
    return np.concatenate([a_re, a_im], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _synthesis_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """(2*bins, n_fft) real matrix: [real|imag] bins -> windowed time frame.

    Matches `window * np.fft.irfft(Z, n_fft)`: the imaginary parts of bin
    0 and the Nyquist bin do not reach the real output.
    """
    bins = n_fft // 2 + 1
    w = padded_window(n_fft, win_length)
    k = np.arange(bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((bins, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    s_re = c * np.cos(ang) / n_fft
    s_im = -c * np.sin(ang) / n_fft
    s_im[0, :] = 0.0
    if n_fft % 2 == 0:
        s_im[-1, :] = 0.0
    m = np.concatenate([s_re, s_im], axis=0)  # (2*bins, n_fft)
    return (m * w[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_table(name: str, n_fft: int, win_length: int,
                  device: torch.device) -> torch.Tensor:
    """Analysis/synthesis matrix as a tensor on `device` (built once)."""
    table = {"analysis": _analysis_matrix,
             "synthesis": _synthesis_matrix}[name](n_fft, win_length)
    return torch.from_numpy(table).to(device)


PFA_FACTORS = (3, 5, 17)  # 255 = n_fft / 2 complex points, coprime factors
# the kernels' float table, in this order (offsets in csrc/pfa.cuh)
PFA_FLOAT_TABLES = ("twiddle", "dft3", "dft5", "dft17", "window",
                    "synth_window")
PFA_INT_TABLES = ("slot_in", "slot_out", "out_index")


def _check_kernel_geometry(n_fft: int, hop_length: int, win_length: int,
                           name: str) -> None:
    """K1 and K3 are compiled for (n_fft, hop, win) = (510, 158, 400)."""
    if (n_fft, hop_length, win_length) != (N_FFT, HOP_LENGTH, WIN_LENGTH):
        raise ValueError(
            f"{name}: the kernel takes the STFT geometry n_fft {N_FFT}, hop "
            f"{HOP_LENGTH}, win {WIN_LENGTH}, got {n_fft}, {hop_length}, "
            f"{win_length}; run other geometries on the CPU")


def _cos_sin(angles: np.ndarray) -> np.ndarray:
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def pfa_tables() -> Dict[str, np.ndarray]:
    """The tables of K1's and K3's prime-factor real DFT, built in float64
    for the one geometry the kernels take (n_fft 510, win 400).

    * `slot_in[m]`: where complex point m of a frame (x[2m] + i x[2m+1])
      sits in the [3][5][17] Good-Thomas array, m = (85 n1 + 51 n2 + 15 n3)
      mod 255 at slot n1*85 + n2*17 + n3 (int32);
    * `slot_out[k]`: the slot where DFT bin k comes out, k = (85 k1 +
      51 k2 + 120 k3) mod 255 (int32), and `out_index`, its inverse;
    * `dft3`, `dft5`, `dft17`: (cos, sin)(2 pi m / N), m < N;
    * `twiddle`: (cos, sin)(2 pi k / 510), k < 256, of the real split;
    * `window`: the analysis window (`padded_window`); `synth_window`:
      the window / 510 of the inverse.
    """
    half = N_FFT // 2
    idx = np.indices(PFA_FACTORS).reshape(len(PFA_FACTORS), -1)  # slot order
    slot = np.arange(half)
    tables = {}
    for name, coef in (("slot_in", [half // n for n in PFA_FACTORS]),
                       ("slot_out", [half // n * pow(half // n, -1, n)
                                     for n in PFA_FACTORS])):
        index = (np.asarray(coef)[:, None] * idx).sum(axis=0) % half
        table = np.empty(half, dtype=np.int32)
        table[index] = slot
        tables[name] = table
    tables["out_index"] = np.argsort(tables["slot_out"]).astype(np.int32)
    for n in PFA_FACTORS:
        tables[f"dft{n}"] = _cos_sin(2.0 * np.pi * np.arange(n) / n)
    tables["twiddle"] = _cos_sin(2.0 * np.pi * np.arange(half + 1) / N_FFT)
    window = padded_window(N_FFT, WIN_LENGTH)
    tables["window"] = window.astype(np.float32)
    tables["synth_window"] = (window / N_FFT).astype(np.float32)
    return tables


@functools.lru_cache(maxsize=8)
def device_pfa_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pfa_tables` packed as the kernels read them: (floats, slots)."""
    tables = pfa_tables()
    floats = np.concatenate([tables[k].ravel() for k in PFA_FLOAT_TABLES])
    slots = np.concatenate([tables[k] for k in PFA_INT_TABLES])
    return (torch.from_numpy(floats).to(device),
            torch.from_numpy(slots).to(device))


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Frame `(..., L)` into `(..., T, n_fft)` at stride `hop`, T = (L-n_fft)//hop + 1."""
    return y.unfold(-1, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add `(..., T, n_fft)` frames at stride `hop` -> `(..., (T-1)*hop + n_fft)`.

    Same summation order as `sos_tpu`: frames are split into hop-sized
    chunks and chunk stream j is added onto the grid at offset j, j = 0
    first, so the sums are bit-equal.
    """
    *lead, num_frames, n_fft = frames.shape
    n_chunks = -(-n_fft // hop)
    pad_f = n_chunks * hop - n_fft
    if pad_f > 0:
        frames = F.pad(frames, (0, pad_f))
    chunks = frames.reshape(*lead, num_frames, n_chunks, hop)
    total = (num_frames + n_chunks) * hop
    out = torch.zeros((*lead, total), dtype=frames.dtype, device=frames.device)
    for j in range(n_chunks):
        stream = chunks[..., :, j, :].reshape(*lead, num_frames * hop)
        out[..., j * hop:(num_frames + j) * hop] += stream
    return out[..., : (num_frames - 1) * hop + n_fft]


@functools.lru_cache(maxsize=16)
def _envelope(num_frames: int, n_fft: int, hop: int,
              win_length: int) -> np.ndarray:
    """Untrimmed window-square overlap-add envelope (float32, sos_tpu's order)."""
    wsq = padded_window(n_fft, win_length).astype(np.float32) ** 2
    tiled = torch.from_numpy(np.tile(wsq, (num_frames, 1)))
    return overlap_add(tiled, hop).numpy()


def _frame_mask(valid_t, lead: Tuple[int, ...], num_frames: int,
                device: torch.device) -> torch.Tensor:
    """`(*lead, T)` float mask of the frames below each row's `valid_t`
    (an int, or a tensor of the leading shape)."""
    vt = torch.as_tensor(valid_t, device=device)
    if vt.dim() and tuple(vt.shape) != tuple(lead):
        raise ValueError(f"valid_t: expected shape {tuple(lead)}, got "
                         f"{tuple(vt.shape)}")
    frames = torch.arange(num_frames, device=device)
    return (frames < vt[..., None]).float().expand(*lead, num_frames)


@functools.lru_cache(maxsize=16)
def _device_window_square(n_fft: int, win_length: int,
                          device: torch.device) -> torch.Tensor:
    """The squared float32 window on `device`, built once (a fresh host
    copy on every call would make the launching thread wait)."""
    wsq = padded_window(n_fft, win_length).astype(np.float32) ** 2
    return torch.from_numpy(wsq).to(device)


def _masked_envelope(mask: torch.Tensor, n_fft: int, hop: int,
                     win_length: int) -> torch.Tensor:
    """Untrimmed window-square envelope of the frames `mask` `(..., T)`
    keeps, in sos_tpu's order (the masked tiling, overlap-added)."""
    wsq = _device_window_square(n_fft, win_length, mask.device)
    return overlap_add(mask[..., None] * wsq, hop)


def _normalize_trim(y: torch.Tensor, num_frames: int, n_fft: int, hop: int,
                    win_length: int, env=None) -> torch.Tensor:
    if env is None:
        env = torch.from_numpy(_envelope(num_frames, n_fft, hop,
                                         win_length)).to(y.device)
    tiny = float(np.finfo(np.float32).tiny)
    y = torch.where(env > tiny, y / torch.where(env > tiny, env, 1.0), y)
    pad = n_fft // 2
    return y[..., pad:-pad] if pad else y


# ---------------------------------------------------------------------------
# K1 — STFT
# ---------------------------------------------------------------------------


def stft_cat_plain(y: torch.Tensor, n_fft: int = N_FFT,
                   hop_length: int = HOP_LENGTH,
                   win_length: int = WIN_LENGTH,
                   center: bool = True) -> torch.Tensor:
    """Plain version of K1: STFT `(..., L)` -> `(..., T, 2*bins)`,
    centered (T = 1 + L // hop) or, with `center=False`, over the buffer
    as given (T = 1 + (L - n_fft) // hop)."""
    pad = n_fft // 2
    y = y.float()
    lead, length = y.shape[:-1], y.shape[-1]
    y = y.reshape(-1, length)
    if center:
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(y, n_fft, hop_length)  # (B, T, n_fft)
    mat = _device_table("analysis", n_fft, win_length, y.device)
    spec = torch.matmul(frames, mat)
    return spec.reshape(*lead, *spec.shape[-2:])


def stft_cat(y: torch.Tensor, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
             win_length: int = WIN_LENGTH, center: bool = True) -> torch.Tensor:
    """STFT `(..., L)` -> packed `(..., T, 2*bins)` = [re | im]; centered,
    or with `center=False` over the caller's pre-padded buffer.

    Kernel K1 on a CUDA tensor, `stft_cat_plain` on a CPU tensor. The
    launches count under "stft" (centered) or "stft_center_false".
    """
    if y.device.type == "cpu":
        return stft_cat_plain(y, n_fft, hop_length, win_length, center)
    _check_kernel_geometry(n_fft, hop_length, win_length, "stft_cat")
    if y.device.type != "cuda":
        raise ValueError(f"stft_cat: unsupported device {y.device}")
    pad = n_fft // 2
    lead, length = y.shape[:-1], y.shape[-1]
    if center and length <= pad:
        raise ValueError(f"stft_cat: reflect padding needs more than {pad} "
                         f"samples, got {length}")
    if not center and length < n_fft:
        raise ValueError(f"stft_cat: center=False needs at least {n_fft} "
                         f"samples, got {length}")
    y2 = y.float().reshape(-1, length).contiguous()
    batch = y2.shape[0]
    frames = (1 + length // hop_length if center
              else 1 + (length - n_fft) // hop_length)
    n_out = 2 * (n_fft // 2 + 1)
    tab, slots = device_pfa_tables(y.device)
    out = torch.empty((batch, frames, n_out), dtype=torch.float32,
                      device=y.device)
    with on_device(y.device) as stream:
        launch("stft" if center else "stft_center_false", "sos_stft",
               y2.data_ptr(), tab.data_ptr(), slots.data_ptr(),
               out.data_ptr(), batch, length, frames, pad if center else 0,
               stream)
    return out.reshape(*lead, frames, n_out)


def stft(y: torch.Tensor, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
         win_length: int = WIN_LENGTH, center: bool = True) -> torch.Tensor:
    """STFT of `(..., L)` -> `(..., F, T, 2)` (real/imag last). `center=False`
    skips the reflect padding (the caller pre-padded, as the
    length-bucketed predictors do)."""
    bins = n_fft // 2 + 1
    spec = stft_cat(y, n_fft, hop_length, win_length, center)
    out = torch.stack([spec[..., :bins], spec[..., bins:]], dim=-1)
    return out.transpose(-3, -2)


def stft_packed(y: torch.Tensor, n_fft: int = N_FFT,
                hop_length: int = HOP_LENGTH, win_length: int = WIN_LENGTH,
                center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT in the packed layout: `(..., L)` -> (re, im), each `(..., T, F)`."""
    bins = n_fft // 2 + 1
    spec = stft_cat(y, n_fft, hop_length, win_length, center)
    return spec[..., :bins], spec[..., bins:]


# ---------------------------------------------------------------------------
# iSTFT (plain) and K3 — cRM recover + iSTFT
# ---------------------------------------------------------------------------


def istft_packed(re: torch.Tensor, im: torch.Tensor, n_fft: int = N_FFT,
                 hop_length: int = HOP_LENGTH, win_length: int = WIN_LENGTH,
                 valid_t=None) -> torch.Tensor:
    """Inverse of :func:`stft_packed`: (re, im) `(..., T, F)` -> `(..., (T-1)*hop)`.

    `valid_t` (an int, or a tensor of the leading shape, on the device):
    each row drops its frames >= valid_t and is normalized by the
    envelope of its valid frames only, so its samples below
    (valid_t-1)*hop equal an unpadded istft's (the caller slices).
    """
    num_frames = re.shape[-2]
    z = torch.cat([re.float(), im.float()], dim=-1)
    env = None
    if valid_t is not None:
        mask = _frame_mask(valid_t, tuple(z.shape[:-2]), num_frames, z.device)
        z = z * mask[..., None]
        env = _masked_envelope(mask, n_fft, hop_length, win_length)
    mat = _device_table("synthesis", n_fft, win_length, z.device)
    frames = torch.matmul(z, mat)
    y = overlap_add(frames, hop_length)
    return _normalize_trim(y, num_frames, n_fft, hop_length, win_length, env)


def istft(spec: torch.Tensor, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
          win_length: int = WIN_LENGTH, valid_t=None) -> torch.Tensor:
    """Inverse of :func:`stft`: `(..., F, T, 2)` -> `(..., (T-1)*hop)` samples
    (`valid_t` as in :func:`istft_packed`)."""
    spec = spec.float().transpose(-3, -2)  # (..., T, F, 2)
    return istft_packed(spec[..., 0], spec[..., 1], n_fft, hop_length,
                        win_length, valid_t)


def crm_istft_plain(crm: torch.Tensor, spec: torch.Tensor, n_fft: int = N_FFT,
                    hop_length: int = HOP_LENGTH, win_length: int = WIN_LENGTH,
                    valid_t=None) -> torch.Tensor:
    """Plain version of K3: packed cRM and mixed STFT `(B, T, 2F)` -> waveform.

    `apply_compressed_crm` (recover, then mask * spec in the complex
    field) followed by `istft_packed` (with `valid_t`, per row).
    """
    bins = n_fft // 2 + 1
    rr = crm_sigmoid_recover(crm[..., :bins].float())
    ri = crm_sigmoid_recover(crm[..., bins:].float())
    mr, mi = spec[..., :bins], spec[..., bins:]
    return istft_packed(rr * mr - ri * mi, rr * mi + ri * mr, n_fft,
                        hop_length, win_length, valid_t)


def crm_istft(crm: torch.Tensor, spec: torch.Tensor, n_fft: int = N_FFT,
              hop_length: int = HOP_LENGTH, win_length: int = WIN_LENGTH,
              valid_t=None) -> torch.Tensor:
    """Denoised waveform `(B, (T-1)*hop)` from the denoiser's packed
    sigmoid cRM `(B, T, 2F)` and the packed mixed STFT `(B, T, 2F)`.
    `valid_t` `(B,)` (integers, on the device): row b keeps its frames
    below valid_t[b] and divides by their envelope alone.

    Kernel K3 on CUDA tensors, `crm_istft_plain` on CPU tensors. The
    launches count under "crm_istft", or "crm_istft_valid_t" with
    `valid_t`.
    """
    if crm.device.type == "cpu" and spec.device.type == "cpu":
        return crm_istft_plain(crm, spec, n_fft, hop_length, win_length,
                               valid_t)
    _check_kernel_geometry(n_fft, hop_length, win_length, "crm_istft")
    bins = n_fft // 2 + 1
    if crm.device.type != "cuda" or spec.device != crm.device:
        raise ValueError(f"crm_istft: tensors on {crm.device} and "
                         f"{spec.device}; the kernel needs one CUDA device")
    if crm.dim() != 3 or crm.shape != spec.shape or crm.shape[-1] != 2 * bins:
        raise ValueError(f"crm_istft: expected two (B, T, {2 * bins}) "
                         f"tensors, got {tuple(crm.shape)} and "
                         f"{tuple(spec.shape)}")
    crm, spec = aligned16(crm.float()), aligned16(spec.float())
    batch, num_frames, _ = crm.shape
    vt = None
    if valid_t is not None:
        # a device tensor stays on the device: no host sync
        vt = torch.as_tensor(valid_t, device=crm.device)
        vt = vt.to(torch.int32).expand(batch).contiguous()
    out_len = (num_frames - 1) * hop_length
    out = torch.empty((batch, out_len), dtype=torch.float32, device=crm.device)
    if out_len == 0:
        return out
    tab, slots = device_pfa_tables(crm.device)
    with on_device(crm.device) as stream:
        launch("crm_istft" if vt is None else "crm_istft_valid_t",
               "sos_crm_istft", crm.data_ptr(), spec.data_ptr(),
               tab.data_ptr(), slots.data_ptr(),
               None if vt is None else vt.data_ptr(), out.data_ptr(), batch,
               num_frames, out_len, stream)
    return out
