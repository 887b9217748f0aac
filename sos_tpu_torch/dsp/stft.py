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

Each kernel has three instances, chosen by `kernel_instance`: at the
default geometry (n_fft 510, hop 158, win 400) the 510-point real DFT
runs as a 255-point complex prime-factor FFT (3 * 5 * 17, `csrc/pfa.cuh`)
from the tables that `pfa_tables` builds here in float64 (`csrc/stft.cu`,
`csrc/crm_istft.cu`); at another geometry whose M complex points (n_fft
/ 2 at even n_fft, n_fft frame pairs at odd) split into odd prime powers
<= 73 and a power of two, n_fft <= 2048, the "fft" instance runs the
same Good-Thomas scheme at run time from `fft_tables` (dense passes for
the odd factors, radix-4/2 stages inside the power of two;
`csrc/fft.cuh`, `csrc/stft_fft.cu`, `csrc/crm_istft_fft.cu`; launches
under "stft_fft*" and "crm_istft_fft*"); at any other geometry a generic
instance runs the dense product with the float64-built
`_analysis_matrix` / `_synthesis_matrix` that the plain versions read
(`csrc/stft_dense.cu`, `csrc/crm_istft_dense.cu`; launches under
"stft_generic*" and "crm_istft_generic*"). Each wrapper runs its plain
PyTorch version (`*_plain`, the dense DFT matmuls) on a CPU tensor and
launches a kernel on a CUDA tensor, whatever the geometry. The plain
products run in full fp32 (`sos_tpu` uses Precision.HIGHEST): callers on
the card keep `torch.backends.cuda.matmul.allow_tf32` False.

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
    """Analysis/synthesis matrix as a tensor on `device` (built once a
    device: callers pass a tensor's device, which names its card)."""
    table = {"analysis": _analysis_matrix,
             "synthesis": _synthesis_matrix}[name](n_fft, win_length)
    return torch.from_numpy(table).to(device)


# K1's generic instance multiplies in tiles of 8 window samples by 128
# output columns (`csrc/stft_dense.cu` kBK, kBN)
DENSE_K_TILE, DENSE_N_TILE = 8, 128


@functools.lru_cache(maxsize=16)
def _device_dense_analysis(n_fft: int, win_length: int,
                           device: torch.device) -> torch.Tensor:
    """`_analysis_matrix`'s rows inside the window's support, zero-padded
    to whole tiles of K1's generic instance (rows to a multiple of
    DENSE_K_TILE, columns to a multiple of DENSE_N_TILE), on `device`."""
    table = _analysis_matrix(n_fft, win_length)
    lpad = (n_fft - win_length) // 2
    rows = -(-win_length // DENSE_K_TILE) * DENSE_K_TILE
    cols = -(-table.shape[1] // DENSE_N_TILE) * DENSE_N_TILE
    out = np.zeros((rows, cols), dtype=np.float32)
    out[:win_length, :table.shape[1]] = table[lpad:lpad + win_length]
    return torch.from_numpy(out).to(device)


PFA_FACTORS = (3, 5, 17)  # 255 = n_fft / 2 complex points, coprime factors
# the kernels' float table, in this order (offsets in csrc/pfa.cuh)
PFA_FLOAT_TABLES = ("twiddle", "dft3", "dft5", "dft17", "window",
                    "synth_window")
PFA_INT_TABLES = ("slot_in", "slot_out", "out_index")


# K3's generic instance keeps the masked spectrum of 64 + chunks - 1
# frames in shared memory, chunks = ceil(n_fft / hop)
# (`csrc/crm_istft_dense.cu` kMaxChunks)
DENSE_MAX_CHUNKS = 1024


def kernel_instance(n_fft: int, hop_length: int, win_length: int) -> str:
    """The K1/K3 instance a geometry launches: "pfa" (the prime-factor
    FFT built for n_fft 510, hop 158, win 400), "fft" (a prime-factor
    FFT at any geometry whose transform `fft_factors` splits and whose
    blocks `fft_launch_shape` fits; n_fft <= FFT_MAX_N_FFT) or "generic"
    (the dense product with the float64-built tables)."""
    if (n_fft, hop_length, win_length) == (N_FFT, HOP_LENGTH, WIN_LENGTH):
        return "pfa"
    if (n_fft <= FFT_MAX_N_FFT and fft_factors(n_fft) is not None
            and fft_launch_shape(n_fft, hop_length) is not None):
        return "fft"
    return "generic"


def _check_geometry(n_fft: int, hop_length: int, win_length: int,
                    name: str) -> None:
    if n_fft < 2 or hop_length < 1 or not 1 <= win_length <= n_fft:
        raise ValueError(f"{name}: needs n_fft >= 2, hop >= 1 and 1 <= win "
                         f"<= n_fft, got {n_fft}, {hop_length}, "
                         f"{win_length}")


def _cos_sin(angles: np.ndarray) -> np.ndarray:
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def pfa_tables() -> Dict[str, np.ndarray]:
    """The tables of K1's and K3's prime-factor real DFT, built in float64
    for the geometry of the prime-factor instances (n_fft 510, win 400).

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


def device_pfa_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pfa_tables` packed as the kernels read them: (floats, slots), on
    `device`, built once a device (a bare "cuda" names the current one,
    so each card keeps its own copy)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _pfa_tables_on(device)


@functools.lru_cache(maxsize=8)
def _pfa_tables_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    tables = pfa_tables()
    floats = np.concatenate([tables[k].ravel() for k in PFA_FLOAT_TABLES])
    slots = np.concatenate([tables[k] for k in PFA_INT_TABLES])
    return (torch.from_numpy(floats).to(device),
            torch.from_numpy(slots).to(device))


# K1's and K3's "fft" instances (`csrc/fft.cuh`, `csrc/stft_fft.cu`,
# `csrc/crm_istft_fft.cu`): the largest n_fft they take, the largest odd
# prime power that runs as one dense pass, the output pairs a thread of a
# dense pass computes (kKB), the plan's layout (a header, then one record
# a pass) and the pass kinds
FFT_MAX_N_FFT = 2048
FFT_MAX_DENSE = 73
FFT_K_BLOCK = 4
FFT_PLAN_HEADER = 4  # plan length, M, passes, coefficient pairs
FFT_PASS_INTS = 5    # kind, n, axis stride, axis length, first coefficient
FFT_DENSE, FFT_RADIX2, FFT_RADIX4 = 1, 2, 4
# the kernels' float table, in this order, and their int table
FFT_FLOAT_TABLES = ("twiddle", "window", "synth_window", "coefs")
FFT_INT_TABLES = ("plan", "slot_in", "slot_out")
# shared memory a block: the usual share (three blocks an SM with the 1 KB
# each reserves, the fastest on an H100 at every geometry measured), and
# the most K3 takes when its frames need more (one block an SM)
FFT_SMEM = 75 * 1024
FFT_SMEM_MAX = 200 * 1024
FFT_MAX_FRAMES = 16  # frames a K1 block, output hops a K3 block


def fft_points(n_fft: int) -> int:
    """Complex points M of the transform: n_fft / 2 at even n_fft (a real
    frame packed as x[2m] + i x[2m+1]), n_fft at odd (two real frames
    packed as one complex frame, separated by conjugate symmetry)."""
    return n_fft // 2 if n_fft % 2 == 0 else n_fft


@functools.lru_cache(maxsize=64)
def fft_factors(n_fft: int):
    """M's prime powers, the power of two first, if each is either odd
    and at most FFT_MAX_DENSE (one dense pass) or a power of two (radix-4
    passes, and one radix-2 pass at an odd exponent); else None."""
    m, factors, p = fft_points(n_fft), [], 2
    if m < 2:
        return None
    while p * p <= m:
        if m % p == 0:
            q = 1
            while m % p == 0:
                q, m = q * p, m // p
            factors.append(q)
        p += 1
    if m > 1:
        factors.append(m)
    if any(q % 2 and q > FFT_MAX_DENSE for q in factors):
        return None
    return tuple(factors)


def _fft_passes(factors):
    """(kind, n, axis stride, axis length) of each pass, in order, over
    the Good-Thomas array [q1][q2]...: the last axis first; a
    power-of-two axis of length N as radix-4 stages of block length N,
    N/4, ... (decimation in frequency), then a radix-2 stage at block
    length 2 when log2 N is odd."""
    strides = [int(np.prod(factors[i + 1:])) for i in range(len(factors))]
    passes = []
    for q, stride in reversed(list(zip(factors, strides))):
        if q % 2:
            passes.append((FFT_DENSE, q, stride, q))
            continue
        length = q
        while length >= 4:
            passes.append((FFT_RADIX4, length, stride, q))
            length //= 4
        if length == 2:
            passes.append((FFT_RADIX2, 2, stride, q))
    return passes


def _digit_reversal(n: int, radices) -> np.ndarray:
    """Where frequency k of an n-point decimation-in-frequency FFT with
    these radices (first stage first) comes out: position digits (m1,
    m2, ...) of place values n/r1, n/(r1 r2), ... hold frequency m1 +
    r1 m2 + r1 r2 m3 + ...."""
    pos = np.arange(n)
    freq, rest, place, weight = np.zeros(n, np.int64), pos.copy(), n, 1
    for r in radices:
        place //= r
        digit = rest // place
        rest = rest % place
        freq += digit * weight
        weight *= r
    out = np.empty(n, np.int64)
    out[freq] = pos
    return out


def _dense_coefs(q: int) -> np.ndarray:
    """A dense pass's (cos, sin)(2 pi (j k mod q) / q) at row k - 1,
    column j - 1 (j, k = 1 .. (q-1)/2), rows zero-padded to whole blocks
    of FFT_K_BLOCK."""
    h = (q - 1) // 2
    rows = -(-h // FFT_K_BLOCK) * FFT_K_BLOCK
    k = np.arange(1, rows + 1)[:, None]
    j = np.arange(1, h + 1)[None, :]
    table = _cos_sin(2.0 * np.pi * ((j * k) % q) / q).astype(np.float64)
    table[h:] = 0.0
    return table.reshape(-1, 2)


@functools.lru_cache(maxsize=16)
def fft_tables(n_fft: int, win_length: int) -> Dict[str, np.ndarray]:
    """The tables of K1's and K3's "fft" instances at one geometry, built
    in float64 (the generalisation of `pfa_tables`):

    * `plan` (int32): FFT_PLAN_HEADER values (the plan's length, M, the
      passes, the coefficient pairs), then per pass (kind, n, axis
      stride, axis length, its first coefficient pair), `_fft_passes`'
      order: a dense pass of n = q points, or a radix-4/2 stage of block
      length n on an axis of the given length;
    * `slot_in[m]`: the slot of input point m, m = (sum_i n_i M / q_i)
      mod M at slot sum_i n_i stride_i (Good-Thomas, no twiddles between
      the factors); `slot_out[k]`: the slot where output k comes out, k
      = (sum_i k_i (M / q_i) ((M / q_i)^-1 mod q_i)) mod M, the
      power-of-two axis's k_i at its digit-reversed position;
    * `coefs`: each dense pass's `_dense_coefs`, then the power-of-two
      axis's twiddles (cos, sin)(2 pi i / N), i < N;
    * `twiddle`: (cos, sin)(2 pi k / n_fft), k <= M, of the real split
      (even n_fft; empty at odd, where frame pairs need none);
    * `window` and `synth_window` (the window / n_fft).
    """
    factors = fft_factors(n_fft)
    if factors is None:
        raise ValueError(f"fft_tables: n_fft {n_fft} does not factor into "
                         f"odd prime powers <= {FFT_MAX_DENSE} and a power "
                         "of two")
    m = fft_points(n_fft)
    strides = [int(np.prod(factors[i + 1:])) for i in range(len(factors))]
    idx = np.indices(factors).reshape(len(factors), -1)  # slot order
    slot = np.arange(m)
    inner = [m // q for q in factors]
    index_in = (np.asarray(inner)[:, None] * idx).sum(axis=0) % m
    slot_in = np.empty(m, np.int32)
    slot_in[index_in] = slot
    # output: frequency k_i of axis i sits at position pos_i(k_i)
    freq = idx.copy()
    for i, q in enumerate(factors):
        if q % 2 == 0:
            radices = [4] * (q.bit_length() - 1 >> 1) + [2] * (
                (q.bit_length() - 1) & 1)
            where = _digit_reversal(q, radices)
            freq[i] = np.argsort(where)[idx[i]]
    crt = [c * pow(c, -1, q) for c, q in zip(inner, factors)]
    index_out = (np.asarray(crt)[:, None] * freq).sum(axis=0) % m
    slot_out = np.empty(m, np.int32)
    slot_out[index_out] = slot
    passes, coefs, offsets = _fft_passes(factors), [], {}
    for kind, n, stride, axis in passes:
        key = (kind == FFT_DENSE, axis)
        if key not in offsets:
            offsets[key] = sum(len(c) for c in coefs)
            coefs.append(_dense_coefs(n) if kind == FFT_DENSE else
                         _cos_sin(2.0 * np.pi * np.arange(axis) / axis))
    header = FFT_PLAN_HEADER + FFT_PASS_INTS * len(passes)
    plan = [header, m, len(passes), sum(len(c) for c in coefs)]
    for kind, n, stride, axis in passes:
        plan += [kind, n, stride, axis, offsets[(kind == FFT_DENSE, axis)]]
    window = padded_window(n_fft, win_length)
    half = np.arange(m + 1) if n_fft % 2 == 0 else np.arange(0)
    return {"plan": np.asarray(plan, np.int32), "slot_in": slot_in,
            "slot_out": slot_out,
            "coefs": np.concatenate(coefs).astype(np.float32),
            "twiddle": _cos_sin(2.0 * np.pi * half / n_fft).reshape(-1, 2),
            "window": window.astype(np.float32),
            "synth_window": (window / n_fft).astype(np.float32)}


@functools.lru_cache(maxsize=64)
def fft_launch_shape(n_fft: int, hop_length: int):
    """How the "fft" instances cut their work, or None where a K3 block
    cannot hold the frames of one output hop: (K1's transforms a block,
    K1's shared bytes, K3's output hops a block, K3's transforms a
    block, K3's shared bytes). A transform is one frame (even n_fft) or
    a pair (odd); a block keeps two buffers of M + 1 points a transform
    and the coefficients in shared memory (`_fft_shared_bytes`). K1 takes
    up to FFT_MAX_FRAMES frames in FFT_SMEM; K3's hops need ceil(n_fft /
    hop) - 1 frames more than they hold, up to FFT_MAX_FRAMES hops in
    FFT_SMEM, or in FFT_SMEM_MAX where FFT_SMEM holds fewer hops than
    that (more than half the frames would be computed twice)."""
    factors = fft_factors(n_fft)
    if factors is None:
        return None
    m, pair = fft_points(n_fft), 1 + n_fft % 2
    ncoef = sum(len(_dense_coefs(q)) if q % 2 else q for q in factors)
    chunks = -(-n_fft // hop_length)

    def transforms(budget):
        nt = 0
        while _fft_shared_bytes(ncoef, nt + 1, m) <= budget:
            nt += 1
        return nt

    k1 = min(FFT_MAX_FRAMES // pair, transforms(FFT_SMEM)) or min(
        1, transforms(FFT_SMEM_MAX))
    if k1 == 0:
        return None
    hops = min(FFT_MAX_FRAMES, transforms(FFT_SMEM) * pair - chunks + 1)
    if hops < chunks:  # more than half of the frames computed twice
        hops = max(hops, min(FFT_MAX_FRAMES,
                             transforms(FFT_SMEM_MAX) * pair - chunks + 1))
    if hops < 1:
        return None
    k3 = -(-(hops + chunks - 1) // pair)
    return (k1, _fft_shared_bytes(ncoef, k1, m), hops, k3,
            _fft_shared_bytes(ncoef, k3, m))


def _fft_shared_bytes(ncoef: int, transforms: int, m: int) -> int:
    """Shared bytes of a block of the "fft" instances (`csrc/fft.cuh`):
    `ncoef` coefficient pairs and two buffers of `transforms` transforms
    of S points (S = M + 1, or M + 2 where that is even); where M is
    divisible by 16, one pad point after every 16 (`padded`) and one
    more."""
    n = transforms * ((m + 1) | 1)
    return 8 * ncoef + 16 * (n + (n // 16 + 1 if m % 16 == 0 else 0))


def device_fft_tables(n_fft: int, win_length: int,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fft_tables` packed as the kernels read them: (floats in
    FFT_FLOAT_TABLES order, ints in FFT_INT_TABLES order), on `device`,
    built once a geometry and device (a bare "cuda" names the current
    card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _fft_tables_on(n_fft, win_length, device)


@functools.lru_cache(maxsize=16)
def _fft_tables_on(n_fft: int, win_length: int, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    tables = fft_tables(n_fft, win_length)
    floats = np.concatenate([tables[k].ravel() for k in FFT_FLOAT_TABLES])
    ints = np.concatenate([tables[k] for k in FFT_INT_TABLES])
    return (torch.from_numpy(floats).to(device),
            torch.from_numpy(ints).to(device))


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
    centered or, with `center=False`, over the buffer as given (T as
    `stft_num_frames` gives it)."""
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


def stft_num_frames(length: int, n_fft: int, hop_length: int,
                    center: bool = True) -> int:
    """Frames of an STFT of `length` samples: those of `frame_signal` on
    the reflect-padded signal (n_fft // 2 at each end; 1 + L // hop at
    even n_fft, 1 + (L - 1) // hop at odd), or on the buffer as given
    with `center=False`."""
    pad = n_fft // 2 if center else 0
    return 1 + (length + 2 * pad - n_fft) // hop_length


def stft_cat(y: torch.Tensor, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
             win_length: int = WIN_LENGTH, center: bool = True) -> torch.Tensor:
    """STFT `(..., L)` -> packed `(..., T, 2*bins)` = [re | im]; centered,
    or with `center=False` over the caller's pre-padded buffer.

    Kernel K1 on a CUDA tensor (the instance `kernel_instance` names),
    `stft_cat_plain` on a CPU tensor. The launches count under "stft"
    (centered) or "stft_center_false", and at a geometry other than the
    default under "stft_fft" / "stft_fft_center_false" ("fft" instance)
    or "stft_generic" / "stft_generic_center_false" (dense instance).
    """
    if y.device.type == "cpu":
        return stft_cat_plain(y, n_fft, hop_length, win_length, center)
    _check_geometry(n_fft, hop_length, win_length, "stft_cat")
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
    frames = stft_num_frames(length, n_fft, hop_length, center)
    n_out = 2 * (n_fft // 2 + 1)
    out = torch.empty((batch, frames, n_out), dtype=torch.float32,
                      device=y.device)
    if kernel_instance(n_fft, hop_length, win_length) == "pfa":
        tab, slots = device_pfa_tables(y.device)
        with on_device(y.device) as stream:
            launch("stft" if center else "stft_center_false", "sos_stft",
                   y2.data_ptr(), tab.data_ptr(), slots.data_ptr(),
                   out.data_ptr(), batch, length, frames,
                   pad if center else 0, stream)
        return out.reshape(*lead, frames, n_out)
    if kernel_instance(n_fft, hop_length, win_length) == "fft":
        tab, ints = device_fft_tables(n_fft, win_length, y.device)
        per_block, smem = fft_launch_shape(n_fft, hop_length)[:2]
        with on_device(y.device) as stream:
            launch("stft_fft" if center else "stft_fft_center_false",
                   "sos_stft_fft", y2.data_ptr(), tab.data_ptr(),
                   ints.data_ptr(), out.data_ptr(), batch, length, frames,
                   n_fft, hop_length, pad if center else 0,
                   (n_fft - win_length) // 2, win_length, per_block, smem,
                   stream)
        return out.reshape(*lead, frames, n_out)
    # the table's rows outside the window's support are zero: skipped
    mat = _device_dense_analysis(n_fft, win_length, y.device)
    with on_device(y.device) as stream:
        launch("stft_generic" if center else "stft_generic_center_false",
               "sos_stft_dense", y2.data_ptr(), mat.data_ptr(),
               out.data_ptr(), batch, length, frames, n_out, mat.shape[1],
               hop_length, pad if center else 0, (n_fft - win_length) // 2,
               win_length, stream)
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

    Kernel K3 on CUDA tensors (the instance `kernel_instance` names),
    `crm_istft_plain` on CPU tensors. The launches count under
    "crm_istft", or "crm_istft_valid_t" with `valid_t`, and at a geometry
    other than the default under "crm_istft_fft" / "crm_istft_fft_valid_t"
    ("fft" instance) or "crm_istft_generic" / "crm_istft_generic_valid_t"
    (dense instance). `(T - 1) * hop + n_fft % 2` samples come
    out, as from `istft`.
    """
    if crm.device.type == "cpu" and spec.device.type == "cpu":
        return crm_istft_plain(crm, spec, n_fft, hop_length, win_length,
                               valid_t)
    _check_geometry(n_fft, hop_length, win_length, "crm_istft")
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
    out_len = (num_frames - 1) * hop_length + n_fft % 2
    out = torch.empty((batch, out_len), dtype=torch.float32, device=crm.device)
    if out_len == 0:
        return out
    vt_ptr = None if vt is None else vt.data_ptr()
    if kernel_instance(n_fft, hop_length, win_length) == "pfa":
        tab, slots = device_pfa_tables(crm.device)
        with on_device(crm.device) as stream:
            launch("crm_istft" if vt is None else "crm_istft_valid_t",
                   "sos_crm_istft", crm.data_ptr(), spec.data_ptr(),
                   tab.data_ptr(), slots.data_ptr(), vt_ptr, out.data_ptr(),
                   batch, num_frames, out_len, stream)
        return out
    if kernel_instance(n_fft, hop_length, win_length) == "fft":
        tab, ints = device_fft_tables(n_fft, win_length, crm.device)
        _, _, hops, per_block, smem = fft_launch_shape(n_fft, hop_length)
        with on_device(crm.device) as stream:
            launch("crm_istft_fft" if vt is None else "crm_istft_fft_valid_t",
                   "sos_crm_istft_fft", crm.data_ptr(), spec.data_ptr(),
                   tab.data_ptr(), ints.data_ptr(), vt_ptr, out.data_ptr(),
                   batch, num_frames, n_fft, hop_length, hops, per_block,
                   smem, out_len, stream)
        return out
    if -(-n_fft // hop_length) > DENSE_MAX_CHUNKS:
        raise ValueError(f"crm_istft: the kernel takes at most "
                         f"{DENSE_MAX_CHUNKS} hops a frame, got n_fft "
                         f"{n_fft}, hop {hop_length}")
    mat = _device_table("synthesis", n_fft, win_length, crm.device)
    wsq = _device_window_square(n_fft, win_length, crm.device)
    with on_device(crm.device) as stream:
        launch("crm_istft_generic" if vt is None
               else "crm_istft_generic_valid_t", "sos_crm_istft_dense",
               crm.data_ptr(), spec.data_ptr(), mat.data_ptr(),
               wsq.data_ptr(), vt_ptr, out.data_ptr(), batch, num_frames,
               bins, n_fft, hop_length, out_len, stream)
    return out
