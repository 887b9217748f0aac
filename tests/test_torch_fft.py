"""K1's and K3's prime-factor real DFT, emulated on the CPU from the
tables the wrappers hand to the kernels (`pfa_tables`).

The emulation below follows the kernels' algorithm step by step: the
reflect-indexed framing, the window, the packing z[m] = x[2m] + i x[2m+1]
into Good-Thomas slots, the 17-, 5- and 3-point passes, the real split
(forward) or the Hermitian packing (inverse), the window / 510, the
overlap-add, the envelope divide (the envelope summed from the squared
window values of the frames that reach a sample, as K3 does it,
optionally only of each row's frames below its `valid_t`) and the trim.
K1's `center=False` case frames the given buffer without the reflect.
It is held against the plain versions (dense DFT matmuls) and against `sos_tpu`'s
`stft_packed` / `istft_packed`: the STFT within atol 1e-5 + rtol 1e-5,
cRM + iSTFT within the repo's atol 1e-4 + rtol 1e-4 (its recovered masks
reach +-46). The kernels themselves run only on a card
(tests/test_torch_kernels.py, chip_smoke.py).

The "fft" instances (`csrc/fft.cuh`) are emulated the same way from the
tables `device_fft_tables` hands them, unpacked by the offsets the
kernels compute, at (1022, 256, 1022) (7 * 73), (511, 158, 400) (7 * 73
on frame pairs) and (512, 128, 512) (2^8): the plan's passes run in its
order (a dense q-point pass in the conjugate-pair form, radix-4/2
decimation-in-frequency stages), centered and `center=False` K1, K3 with
and without `valid_t`, at the same tolerances, on clips of a few frames.
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


def emulate_stft(y: torch.Tensor, center: bool = True) -> torch.Tensor:
    """K1: (B, L) -> packed (B, T, 512)."""
    tabs = _tables()
    length = y.shape[-1]
    pad = PAD if center else 0
    frames = 1 + length // HOP if center else 1 + (length - N_FFT) // HOP
    q = torch.arange(frames)[:, None] * HOP + torch.arange(N_FFT)[None] - pad
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


def emulate_crm_istft(crm: torch.Tensor, spec: torch.Tensor,
                      valid_t=None) -> torch.Tensor:
    """K3: packed cRM and spectrum (B, T, 512) -> (B, (T-1)*158)."""
    tabs = _tables()
    batch, frames, _ = crm.shape
    tv = torch.full((batch,), frames) if valid_t is None else valid_t
    live = (torch.arange(frames)[None] < tv[:, None]).float()  # (B, T)
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
    frame = frame * tabs["synth_window"] * live[..., None]
    wsq = (tabs["window"] * tabs["window"]) * live[..., None]  # (B, T, 510)
    full = torch.zeros(batch, (frames + 3) * HOP)
    env = torch.zeros(batch, (frames + 3) * HOP)
    for c in range(4):  # chunk c of every frame, chunk 0 first
        for acc, src in ((full, frame), (env, wsq)):
            chunk = src[..., c * HOP:(c + 1) * HOP]
            acc[:, c * HOP:c * HOP + frames * HOP].view(batch, frames, HOP)[
                ..., :chunk.shape[-1]] += chunk
    out_len = (frames - 1) * HOP
    env = env[:, PAD:PAD + out_len]
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


def test_stft_center_false_emulation_matches_plain_and_sos_tpu():
    """K1 without the reflect: a reflect-padded, zero-extended buffer as
    the bucketed predictors build it."""
    y = _clips(20000)
    buf = np.zeros((2, (200 - 1) * HOP + N_FFT), np.float32)
    padded = np.pad(y, ((0, 0), (PAD, PAD)), mode="reflect")
    buf[:, :padded.shape[1]] = padded
    got = emulate_stft(torch.from_numpy(buf), center=False)
    plain = tstft.stft_cat_plain(torch.from_numpy(buf), center=False)
    assert got.shape == plain.shape == (2, 200, 2 * BINS)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    re, im = jstft.stft_packed(jnp.asarray(buf), center=False)
    ref = np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    # the first 1 + 20000 // 158 frames are the centered STFT's
    centered = tstft.stft_cat_plain(torch.from_numpy(y))
    torch.testing.assert_close(got[:, :centered.shape[1]], centered,
                               atol=1e-5, rtol=1e-5)


def _live_reach(valid_t: int, n_fft: int, hop: int) -> int:
    """Output samples a row of `valid_t` frames can reach: the last live
    frame's last sample, trimmed; every sample from there on is exactly 0
    (no frame, envelope 0)."""
    return max(0, (valid_t - 1) * hop + n_fft - n_fft // 2) if valid_t else 0


def _assert_dead_blocks_past_reach(valid_t, n_fft, hop, block_hops, out_len):
    """The valid_t kernels' rule (csrc/crm_istft*.cu): a block whose first
    output hop is h0 reads frames from h0 - (ceil(n_fft / hop) - 1), and
    is dead, storing zeros without computing, when valid_t <= max(0, that
    frame). Every sample of a dead block lies at or past the row's live
    reach, so the zeros it stores are the output's."""
    chunks = -(-n_fft // hop)
    rows = (out_len + n_fft // 2 - 1) // hop + 1  # hops holding output
    for v in valid_t:
        for h0 in range(0, rows, block_hops):
            if v <= max(0, h0 - (chunks - 1)):
                assert max(0, h0 * hop - n_fft // 2) >= _live_reach(
                    v, n_fft, hop)


def test_crm_istft_valid_t_emulation_matches_plain_and_sos_tpu():
    """K3 with per-row valid_t, from the full bucket down to 1 frame and
    none: against the plain version, against sos_tpu's istft(valid_t=)
    per row, (below (valid_t - 1) * 158) against an unpadded row, and
    exactly 0 from each row's live reach on, where the kernel's dead
    blocks (13 hops a block) store zeros."""
    y = _clips(28000)
    spec = tstft.stft_cat_plain(torch.from_numpy(y))
    frames = spec.shape[1]
    spec = spec.repeat(4, 1, 1)
    crm = torch.from_numpy(np.concatenate([_crm(frames, 28000)] * 4))
    valid_t = torch.tensor([frames, 1, 2, 120, 57, frames - 1, 0, 3])
    got = emulate_crm_istft(crm, spec, valid_t)
    plain = tstft.crm_istft_plain(crm, spec, valid_t=valid_t)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    for row, v in enumerate(valid_t.tolist()):
        reach = _live_reach(v, N_FFT, HOP)
        assert not got[row, reach:].any() and not plain[row, reach:].any()
    _assert_dead_blocks_past_reach(valid_t.tolist(), N_FFT, HOP, 13,
                                   got.shape[1])
    for row, v in enumerate(valid_t.tolist()):
        s = jnp.asarray(spec[row:row + 1].numpy())
        c = crm[row:row + 1].numpy()
        rr = jcrm.crm_sigmoid_recover(jnp.asarray(c[..., :BINS]))
        ri = jcrm.crm_sigmoid_recover(jnp.asarray(c[..., BINS:]))
        mr, mi = s[..., :BINS], s[..., BINS:]
        ref_spec = jnp.stack([rr * mr - ri * mi, rr * mi + ri * mr], -1)
        ref = np.asarray(jstft.istft(jnp.swapaxes(ref_spec, -3, -2),
                                     valid_t=jnp.int32(v)))
        np.testing.assert_allclose(got[row:row + 1].numpy(), ref,
                                   atol=1e-4, rtol=1e-4)
        n = (v - 1) * HOP
        if n > 0:
            alone = tstft.crm_istft_plain(crm[row:row + 1, :v],
                                          spec[row:row + 1, :v])
            torch.testing.assert_close(got[row, :n], alone[0, :n],
                                       atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The "fft" instances at other geometries (`fft_tables`, csrc/fft.cuh)
# ---------------------------------------------------------------------------

FFT_GEOMETRIES = [(1022, 256, 1022), (511, 158, 400), (512, 128, 512)]


def _fft_tabs(n_fft, win):
    """The "fft" tables as the kernels receive them, unpacked by the
    offsets the kernels compute: the float table's twiddles (2 (M + 1)
    floats at even n_fft, none at odd), window, synthesis window, then
    the coefficients; the int table's plan (its length is its first
    value), then slot_in and slot_out (M each)."""
    floats, ints = (t.numpy() for t in tstft.device_fft_tables(
        n_fft, win, torch.device("cpu")))
    plan_len, m = int(ints[0]), int(ints[1])
    tw = 2 * (m + 1) if n_fft % 2 == 0 else 0
    out = {"plan": ints[:plan_len].astype(np.int64),
           "slot_in": torch.from_numpy(ints[plan_len:plan_len + m].astype(np.int64)),
           "slot_out": torch.from_numpy(ints[plan_len + m:plan_len + 2 * m].astype(np.int64))}
    assert ints.size == plan_len + 2 * m
    for name, lo, hi in (("twiddle", 0, tw), ("window", tw, tw + n_fft),
                         ("synth_window", tw + n_fft, tw + 2 * n_fft),
                         ("coefs", tw + 2 * n_fft, floats.size)):
        out[name] = torch.from_numpy(floats[lo:hi].copy())
    out["twiddle"] = out["twiddle"].reshape(-1, 2)
    out["coefs"] = out["coefs"].reshape(-1, 2)
    assert out["coefs"].shape[0] == out["plan"][3]
    return out


def _fft_passes(z, tabs, inverse):
    """The plan's passes over z (..., M), complex, in slot order: a dense
    q-point pass in the conjugate-pair form (S_j = a_j + a_{q-j}, D_j =
    a_j - a_{q-j}; out[k] = a_0 + sum_j c S_j -/+ i sum_j s D_j, out[q-k]
    the other sign), or a radix-4/2 decimation-in-frequency stage of
    block length L (a 4- or 2-point DFT, then the twiddles W_L^{jm})."""
    plan, coefs = tabs["plan"], tabs["coefs"]
    lead, m = z.shape[:-1], z.shape[-1]
    sign = 1.0 if inverse else -1.0
    for i in range(int(plan[2])):
        kind, n, stride, axis, off = (int(v) for v in plan[
            tstft.FFT_PLAN_HEADER + tstft.FFT_PASS_INTS * i:][:5])
        a = z.reshape(*lead, m // (stride * axis), axis, stride)
        if kind == tstft.FFT_DENSE:
            h = (n - 1) // 2
            rows = -(-h // tstft.FFT_K_BLOCK) * tstft.FFT_K_BLOCK
            tab = coefs[off:off + rows * h].reshape(rows, h, 2)[:h]
            a0, u = a[..., :1, :], a[..., 1:h + 1, :]
            v = torch.flip(a[..., n - h:, :], dims=[-2])  # a[q - j]
            s_j, d_j = u + v, u - v
            p = a0 + torch.einsum("kj,...js->...ks", tab[..., 0].to(z.dtype), s_j)
            q = torch.einsum("kj,...js->...ks", tab[..., 1].to(z.dtype), d_j)
            first, second = p + sign * 1j * q, p - sign * 1j * q
            z = torch.cat([a0 + s_j.sum(-2, keepdim=True), first,
                           torch.flip(second, dims=[-2])], dim=-2)
        else:
            r = 4 if kind == tstft.FFT_RADIX4 else 2
            b = a.reshape(*lead, m // (stride * axis), axis // n, r, n // r,
                          stride)
            x = [b[..., l, :, :] for l in range(r)]
            if r == 4:
                t0, t1, t2, t3 = x[0] + x[2], x[0] - x[2], x[1] + x[3], x[1] - x[3]
                y = [t0 + t2, t1 + sign * 1j * t3, t0 - t2, t1 - sign * 1j * t3]
            else:
                y = [x[0] + x[1], x[0] - x[1]]
            j = torch.arange(n // r)
            for mm in range(1, r):
                w = coefs[off + j * mm * (axis // n)]
                y[mm] = y[mm] * torch.complex(w[:, 0], sign * w[:, 1])[:, None]
            z = torch.stack(y, dim=-3)
        z = z.reshape(*lead, m)
    return z


def emulate_fft_stft(y, n_fft, hop, win, center=True):
    """K1's "fft" instance: (B, L) -> packed (B, T, 2 bins)."""
    tabs = _fft_tabs(n_fft, win)
    m, bins, length = tstft.fft_points(n_fft), n_fft // 2 + 1, y.shape[-1]
    pad = n_fft // 2 if center else 0
    frames = tstft.stft_num_frames(length, n_fft, hop, center)
    q = torch.arange(frames)[:, None] * hop + torch.arange(n_fft)[None] - pad
    q = torch.where(q < 0, -q, q)
    q = torch.where(q >= length, 2 * (length - 1) - q, q)
    x = y[:, q] * tabs["window"]
    if n_fft % 2 == 0:
        z = torch.complex(x[..., 0::2], x[..., 1::2])
    else:  # frames 2t and 2t + 1 in one transform
        x = torch.cat([x, x.new_zeros(x.shape[0], frames % 2, n_fft)], dim=1)
        z = torch.complex(x[:, 0::2], x[:, 1::2])
    buf = torch.empty_like(z)
    buf[..., tabs["slot_in"]] = z
    zz = _fft_passes(buf, tabs, inverse=False)[..., tabs["slot_out"]]
    k = torch.arange(bins)
    zk, zm = zz[..., k % m], zz[..., (m - k) % m].conj()
    even, odd = (zk + zm) / 2, (zk - zm) / 2j
    if n_fft % 2 == 0:
        tw = tabs["twiddle"]
        spec = even + torch.complex(tw[:, 0], -tw[:, 1]) * odd
    else:
        spec = torch.stack([even, odd], dim=2).reshape(y.shape[0], -1, bins)[:, :frames]
    return torch.cat([spec.real, spec.imag], dim=-1)


def emulate_fft_crm_istft(crm, spec, n_fft, hop, win, valid_t=None):
    """K3's "fft" instance: packed cRM and spectrum (B, T, 2 bins) ->
    (B, (T - 1) hop + n_fft % 2)."""
    tabs = _fft_tabs(n_fft, win)
    m, bins = tstft.fft_points(n_fft), n_fft // 2 + 1
    batch, frames, _ = crm.shape
    tv = torch.full((batch,), frames) if valid_t is None else valid_t
    live = (torch.arange(frames)[None] < tv[:, None]).float()  # (B, T)
    rr, ri = crm_sigmoid_recover(crm[..., :bins]), crm_sigmoid_recover(crm[..., bins:])
    mr, mi = spec[..., :bins], spec[..., bins:]
    im = rr * mi + ri * mr
    im[..., 0] = 0.0  # bin 0 (and at even n_fft the last) lose their imaginary parts
    if n_fft % 2 == 0:
        im[..., -1] = 0.0
    x = torch.complex(rr * mr - ri * mi, im) * live[..., None]  # absent frames: 0
    if n_fft % 2 == 0:
        k = torch.arange(m)
        a, b = x[..., k], x[..., m - k].conj()
        tw = tabs["twiddle"][:m]
        z = (a + b) + 1j * (a - b) * torch.complex(tw[:, 0], tw[:, 1])
    else:  # Hermitian extension of each frame of a pair, then a + i b
        x = torch.cat([x, x.new_zeros(batch, frames % 2, bins)], dim=1)
        ext = torch.cat([x, torch.flip(x[..., 1:], dims=[-1]).conj()], dim=-1)
        z = ext[:, 0::2] + 1j * ext[:, 1::2]
    buf = torch.empty_like(z)
    buf[..., tabs["slot_in"]] = z
    zz = _fft_passes(buf, tabs, inverse=True)[..., tabs["slot_out"]]
    if n_fft % 2 == 0:
        frame = torch.stack([zz.real, zz.imag], dim=-1).reshape(batch, frames, n_fft)
    else:
        frame = torch.stack([zz.real, zz.imag], dim=2).reshape(batch, -1, n_fft)[:, :frames]
    frame = frame * tabs["synth_window"] * live[..., None]
    wsq = (tabs["window"] * tabs["window"]) * live[..., None]
    chunks = -(-n_fft // hop)
    full = torch.zeros(batch, (frames + chunks) * hop)
    env = torch.zeros(batch, (frames + chunks) * hop)
    for c in range(chunks):  # chunk c of every frame, chunk 0 first
        for acc, src in ((full, frame), (env, wsq)):
            chunk = src[..., c * hop:(c + 1) * hop]
            acc[:, c * hop:c * hop + frames * hop].view(batch, frames, hop)[
                ..., :chunk.shape[-1]] += chunk
    pad, out_len = n_fft // 2, (frames - 1) * hop + n_fft % 2
    env, y = env[:, pad:pad + out_len], full[:, pad:pad + out_len]
    tiny = float(np.finfo(np.float32).tiny)
    return torch.where(env > tiny, y / torch.where(env > tiny, env, 1.0), y)


def _short_clips(n_fft, length):
    """Two short clips of noise with spikes, as `_clips`, where the
    reflect pad reads (the first and last n_fft / 2 samples)."""
    y = np.random.default_rng(n_fft + length).standard_normal((2, length)).astype(
        np.float32) * 0.3
    y[:, [0, 3, 101, n_fft // 2 - 1]] += np.float32([4.0, -3.0, 2.5, 5.0])
    y[:, [-1, -2, -97, -(n_fft // 2)]] += np.float32([-4.0, 3.5, 2.0, -5.0])
    return y


def _jax_crm_istft(crm, spec, n_fft, hop, win, valid_t=None):
    """`sos_tpu`'s recover + apply + istft, per row with `valid_t`."""
    bins = n_fft // 2 + 1
    rows = []
    for row in range(crm.shape[0]):
        s = jnp.asarray(spec[row:row + 1])
        rr = jcrm.crm_sigmoid_recover(jnp.asarray(crm[row:row + 1, :, :bins]))
        ri = jcrm.crm_sigmoid_recover(jnp.asarray(crm[row:row + 1, :, bins:]))
        mr, mi = s[..., :bins], s[..., bins:]
        kw = {} if valid_t is None else {"valid_t": jnp.int32(valid_t[row])}
        z = jnp.stack([rr * mr - ri * mi, rr * mi + ri * mr], -1)
        rows.append(np.asarray(jstft.istft(jnp.swapaxes(z, -3, -2), n_fft,
                                           hop, win, **kw)))
    return np.concatenate(rows)


@pytest.mark.parametrize("n_fft,hop,win", FFT_GEOMETRIES)
def test_fft_tables(n_fft, hop, win):
    """Which instance, and the slot maps: scattering a frame by slot_in,
    taking each axis's plain DFT (numpy, float64) and gathering by
    slot_out gives the M-point DFT, whatever the passes."""
    assert tstft.kernel_instance(n_fft, hop, win) == "fft"
    tabs = tstft.fft_tables(n_fft, win)
    m = tstft.fft_points(n_fft)
    for name in ("slot_in", "slot_out"):
        assert tabs[name].dtype == np.int32
        np.testing.assert_array_equal(np.sort(tabs[name]), np.arange(m))
    factors = tstft.fft_factors(n_fft)
    z = np.random.default_rng(m).standard_normal((m, 2)) @ np.array([1.0, 1j])
    buf = np.empty(m, complex)
    buf[tabs["slot_in"]] = z
    a = buf.reshape(factors)
    for axis, q in enumerate(factors):
        a = np.fft.fft(a, axis=axis)
        if q % 2 == 0:  # the radix stages leave frequency f at where[f]
            e = q.bit_length() - 1
            where = tstft._digit_reversal(q, [4] * (e // 2) + [2] * (e % 2))
            a = np.take(a, np.argsort(where), axis=axis)
    np.testing.assert_allclose(a.reshape(m)[tabs["slot_out"]], np.fft.fft(z),
                               atol=1e-9)
    np.testing.assert_array_equal(tabs["window"],
                                  tstft.padded_window(n_fft, win).astype(np.float32))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop,win", FFT_GEOMETRIES)
def test_fft_stft_emulation_matches_plain_and_sos_tpu(n_fft, hop, win, center):
    y = _short_clips(n_fft, 5 * hop + n_fft + 37)
    got = emulate_fft_stft(torch.from_numpy(y), n_fft, hop, win, center)
    plain = tstft.stft_cat_plain(torch.from_numpy(y), n_fft, hop, win, center)
    assert got.shape == plain.shape == (
        2, tstft.stft_num_frames(y.shape[1], n_fft, hop, center), 2 * (n_fft // 2 + 1))
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    re, im = jstft.stft_packed(jnp.asarray(y), n_fft, hop, win, center=center)
    ref = np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("n_fft,hop,win", FFT_GEOMETRIES)
def test_fft_crm_istft_emulation_matches_plain_and_sos_tpu(n_fft, hop, win, valid):
    y = _short_clips(n_fft, 6 * hop + 11)
    spec = tstft.stft_cat_plain(torch.from_numpy(y), n_fft, hop, win)
    frames = spec.shape[1]
    o = np.random.default_rng(n_fft).uniform(0.01, 0.99, spec.shape)
    o.reshape(-1)[::7], o.reshape(-1)[3::7] = 0.01, 0.99
    crm = torch.from_numpy(o.astype(np.float32))
    valid_t = None
    if valid:  # the whole bucket, 2, 1 and no frame
        crm, spec = crm.repeat(2, 1, 1), spec.repeat(2, 1, 1)
        valid_t = torch.tensor([frames, 2, 1, 0])
    got = emulate_fft_crm_istft(crm, spec, n_fft, hop, win, valid_t)
    plain = tstft.crm_istft_plain(crm, spec, n_fft, hop, win, valid_t)
    assert got.shape == plain.shape == (crm.shape[0],
                                        (frames - 1) * hop + n_fft % 2)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    ref = _jax_crm_istft(crm.numpy(), spec.numpy(), n_fft, hop, win,
                         None if valid_t is None else valid_t.tolist())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    if valid:  # exactly 0 from the live reach on, where dead blocks store
        for row, v in enumerate(valid_t.tolist()):
            reach = _live_reach(v, n_fft, hop)
            assert not got[row, reach:].any()
            assert not plain[row, reach:].any()
        # the "fft" instance's output hops a block, and the generic
        # instance's 64 hop rows a tile
        for block_hops in (tstft.fft_launch_shape(n_fft, hop)[2], 64):
            _assert_dead_blocks_past_reach(valid_t.tolist(), n_fft, hop,
                                           block_hops, got.shape[1])
