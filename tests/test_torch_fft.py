"""K1's and K3's prime-factor real DFT, emulated on the CPU from the
tables the wrappers hand to the kernels (`pfa_tables`).

The emulation below follows the kernels' algorithm step by step: the
reflect-indexed framing, the window, the packing z[m] = x[2m] + i x[2m+1]
into Good-Thomas slots, the 17-, 5- and 3-point passes, the real split
(forward) or the Hermitian packing (inverse), the window / 510, the
overlap-add, the envelope divide and the trim. It is held against the
plain versions (dense DFT matmuls) and against `sos_tpu`'s
`stft_packed` / `istft_packed`: the STFT within atol 1e-5 + rtol 1e-5,
cRM + iSTFT within the repo's atol 1e-4 + rtol 1e-4 (its recovered masks
reach +-46). The kernels themselves run only on a card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.dsp import crm as jcrm
from sos_tpu_torch.dsp import stft as tstft
from sos_tpu_torch.dsp.crm import crm_sigmoid_recover

jstft = importlib.import_module("sos_tpu.dsp.stft")

N_FFT, HOP, PAD, M, BINS = 510, 158, 255, 255, 256
LENGTHS = (28000, 14000 + 97)


def _tables():
    """The tables as the kernels receive them, unpacked from the device
    tensors by the float layout the kernels' offsets follow."""
    floats, slots = (t.numpy() for t in tstft.device_pfa_tables(torch.device("cpu")))
    ref = tstft.pfa_tables()
    out, at = {}, 0
    for name in tstft.PFA_FLOAT_TABLES:
        size = ref[name].size
        out[name] = torch.from_numpy(floats[at:at + size].reshape(ref[name].shape))
        at += size
    for i, name in enumerate(tstft.PFA_INT_TABLES):
        out[name] = torch.from_numpy(slots[i * M:(i + 1) * M].astype(np.int64))
    return out


def _small_dft(a, dim, tab, inverse):
    n = a.shape[dim]
    j = torch.arange(n)
    m = (j[:, None] * j[None, :]) % n
    w = torch.complex(tab[m, 0], (1.0 if inverse else -1.0) * tab[m, 1])
    return torch.movedim(torch.movedim(a, dim, -1) @ w, -1, dim)


def _pfa255(z, tabs, inverse):
    """255-point DFT: scatter to slots, the three passes; slot order out."""
    buf = torch.empty_like(z)
    buf[..., tabs["slot_in"]] = z
    a = buf.reshape(*z.shape[:-1], 3, 5, 17)
    for dim, name in ((-1, "dft17"), (-2, "dft5"), (-3, "dft3")):
        a = _small_dft(a, dim, tabs[name], inverse)
    return a.reshape(z.shape)


def emulate_stft(y: torch.Tensor) -> torch.Tensor:
    """K1: (B, L) -> packed (B, T, 512)."""
    tabs = _tables()
    length = y.shape[-1]
    frames = 1 + length // HOP
    q = torch.arange(frames)[:, None] * HOP + torch.arange(N_FFT)[None] - PAD
    q = torch.where(q < 0, -q, q)
    q = torch.where(q >= length, 2 * (length - 1) - q, q)
    x = y[:, q] * tabs["window"]
    z = _pfa255(torch.complex(x[..., 0::2], x[..., 1::2]), tabs, inverse=False)
    z = z[..., tabs["slot_out"]]  # the split gathers bin k from slot_out[k]
    k = torch.arange(BINS)
    zk, zm = z[..., k % M], z[..., (M - k) % M].conj()
    even, odd = (zk + zm) / 2, (zk - zm) / 2j
    tw = tabs["twiddle"]
    spec = even + torch.complex(tw[:, 0], -tw[:, 1]) * odd
    return torch.cat([spec.real, spec.imag], dim=-1)


def emulate_crm_istft(crm: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """K3: packed cRM and spectrum (B, T, 512) -> (B, (T-1)*158)."""
    tabs = _tables()
    batch, frames, _ = crm.shape
    rr, ri = crm_sigmoid_recover(crm[..., :BINS]), crm_sigmoid_recover(crm[..., BINS:])
    mr, mi = spec[..., :BINS], spec[..., BINS:]
    im = rr * mi + ri * mr
    im[..., 0] = 0.0   # bins 0 and 255 lose their imaginary parts
    im[..., -1] = 0.0
    x = torch.complex(rr * mr - ri * mi, im)
    k = torch.arange(M)
    a, b = x[..., k], x[..., M - k].conj()
    tw = tabs["twiddle"][:M]
    slots = _pfa255((a + b) + 1j * (a - b) * torch.complex(tw[:, 0], tw[:, 1]),
                    tabs, inverse=True)
    z = torch.empty_like(slots)
    z[..., tabs["out_index"]] = slots  # the last pass stores in sample order
    frame = torch.stack([z.real, z.imag], dim=-1).reshape(batch, frames, N_FFT)
    frame = frame * tabs["synth_window"]
    full = torch.zeros(batch, (frames + 3) * HOP)
    for c in range(4):  # chunk c of every frame, chunk 0 first
        chunk = frame[..., c * HOP:(c + 1) * HOP]
        full[:, c * HOP:c * HOP + frames * HOP].view(batch, frames, HOP)[
            ..., :chunk.shape[-1]] += chunk
    out_len = (frames - 1) * HOP
    env = tstft._device_envelope(frames, N_FFT, HOP, 400, torch.device("cpu"))
    y = full[:, PAD:PAD + out_len]
    tiny = float(np.finfo(np.float32).tiny)
    return torch.where(env > tiny, y / torch.where(env > tiny, env, 1.0), y)


def _clips(length):
    """Noise with spikes in the first and last 255 samples."""
    y = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32) * 0.3
    y[:, [0, 3, 101, 254]] += np.float32([4.0, -3.0, 2.5, 5.0])
    y[:, [-1, -2, -97, -255]] += np.float32([-4.0, 3.5, 2.0, -5.0])
    return y


def _crm(frames, length):
    """cRM in (0.01, 0.99), every 7th value at an end of the range."""
    o = np.random.default_rng(length + 1).uniform(0.01, 0.99, (2, frames, 2 * BINS))
    o.reshape(-1)[::7] = 0.01
    o.reshape(-1)[3::7] = 0.99
    return o.astype(np.float32)


def test_pfa_tables():
    tabs = tstft.pfa_tables()
    np.testing.assert_array_equal(tabs["slot_out"][tabs["out_index"]], np.arange(M))
    for name in tstft.PFA_INT_TABLES:
        assert tabs[name].dtype == np.int32
        np.testing.assert_array_equal(np.sort(tabs[name]), np.arange(M))
    # slot n1*85 + n2*17 + n3 holds input index 85 n1 + 51 n2 + 15 n3 and
    # output index 85 k1 + 51 k2 + 120 k3 (mod 255)
    n1, n2, n3 = np.indices((3, 5, 17)).reshape(3, -1)
    np.testing.assert_array_equal(tabs["slot_in"][(85 * n1 + 51 * n2 + 15 * n3) % M],
                                  np.arange(M))
    np.testing.assert_array_equal(tabs["slot_out"][(85 * n1 + 51 * n2 + 120 * n3) % M],
                                  np.arange(M))
    np.testing.assert_array_equal(tabs["window"], tstft.padded_window().astype(np.float32))
    assert tabs["twiddle"].shape == (BINS, 2) and tabs["dft17"].shape == (17, 2)
    # the packed float table matches the kernels' offsets (csrc/pfa.cuh)
    floats, slots = tstft.device_pfa_tables(torch.device("cpu"))
    assert floats.numel() == 2 * BINS + 2 * (3 + 5 + 17) + 2 * N_FFT == 1582
    assert slots.dtype == torch.int32 and slots.numel() == 3 * M


@pytest.mark.parametrize("length", LENGTHS)
def test_stft_emulation_matches_plain_and_sos_tpu(length):
    y = _clips(length)
    got = emulate_stft(torch.from_numpy(y))
    plain = tstft.stft_cat_plain(torch.from_numpy(y))
    assert got.shape == plain.shape == (2, 1 + length // HOP, 2 * BINS)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    re, im = jstft.stft_packed(jnp.asarray(y))
    ref = np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("length", LENGTHS)
def test_crm_istft_emulation_matches_plain_and_sos_tpu(length):
    y = _clips(length)
    spec = tstft.stft_cat_plain(torch.from_numpy(y))
    crm = _crm(spec.shape[1], length)
    got = emulate_crm_istft(torch.from_numpy(crm), spec)
    plain = tstft.crm_istft_plain(torch.from_numpy(crm), spec)
    assert got.shape == plain.shape == (2, (spec.shape[1] - 1) * HOP)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    s = jnp.asarray(spec.numpy())
    rr = jcrm.crm_sigmoid_recover(jnp.asarray(crm[..., :BINS]))
    ri = jcrm.crm_sigmoid_recover(jnp.asarray(crm[..., BINS:]))
    mr, mi = s[..., :BINS], s[..., BINS:]
    ref = np.asarray(jstft.istft_packed(rr * mr - ri * mi, rr * mi + ri * mr))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
