"""The port's CUDA kernels: their bindings here, their results on a card.

This file imports neither JAX nor `sos_tpu`, so it also runs on the
machine with the card, where JAX is absent (tests/conftest.py imports
it, hence `--noconftest`):

    python -m pytest tests/test_torch_kernels.py -q --noconftest -p no:cacheprovider

On a host without a card the `cuda`-marked tests skip; the rest check
what surrounds the kernels: the ctypes signatures against the C
sources, the build's source hash, and that no wrapper runs anything but
its kernel on a non-CPU tensor.
"""

import ctypes
import re
import shutil
from pathlib import Path

import pytest
import torch

from sos_tpu_torch.config import (DataConfig, DenoiserModelConfig,
                                  DetectorModelConfig, ExperimentConfig)
from sos_tpu_torch.dsp import mixing, stft
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.kernels import ENTRY_LAUNCHES, LAUNCHES, aligned16
from sos_tpu_torch.kernels import build as kbuild
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, init_state_dict
from sos_tpu_torch.ops import int8_conv, int8_gemm, lstm

RATIO = 14000 / 30.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py covers the kernels there)")
    return torch.device("cuda")


def _c_signatures():
    """`extern "C" int sos_*(...)` entry points -> parameter C types."""
    text = "\n".join(p.read_text() for p in sorted(kbuild.CSRC.glob("*.cu")))
    found = {}
    for name, params in re.findall(r'extern "C" int (sos_\w+)\(([^)]*)\)', text):
        found[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return found


def test_ctypes_bindings_match_the_c_sources():
    sigs = _c_signatures()
    assert sorted(sigs) == sorted(kbuild.SIGNATURES)
    for name, argtypes in kbuild.SIGNATURES.items():
        ctypes_of = [ctypes.c_void_p if "*" in c else ctypes.c_int for c in sigs[name]]
        assert list(argtypes) == ctypes_of, name


def test_source_hash_names_the_build(tmp_path, monkeypatch):
    for src in kbuild.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(kbuild, "CSRC", tmp_path)
    before = kbuild._digest()
    (tmp_path / "stft.cu").write_text((tmp_path / "stft.cu").read_text() + "\n")
    assert kbuild._digest() != before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if Path("/usr/local/cuda/bin/nvcc").exists() or shutil.which("nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build()
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors: anything
    else is the kernel's or an error, never a quiet fallback."""
    meta = torch.device("meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        stft.stft_cat(torch.empty(2, 28000, device=meta))
    with pytest.raises(ValueError, match="meta"):
        mixing.mask_gate(torch.empty(2, 28000, device=meta),
                         torch.empty(2, 60, device=meta), RATIO)
    with pytest.raises(ValueError, match="meta"):
        stft.crm_istft(torch.empty(2, 178, 512, device=meta),
                       torch.empty(2, 178, 512, device=meta))
    with pytest.raises(ValueError, match="meta"):
        lstm.bilstm_recurrence(*(torch.empty(2, 5, 16, device=meta),) * 2,
                               *(torch.empty(16, 4, device=meta),) * 2)
    assert LAUNCHES == before


def test_training_wrappers_refuse_other_devices():
    """The training path's instances (K2 complement, K4's training
    forward, K4b): plain only on the CPU."""
    meta = torch.device("meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        mixing.mask_gate(torch.empty(2, 28000, device=meta),
                         torch.empty(2, 60, device=meta), RATIO,
                         complement=True)
    with pytest.raises(ValueError, match="meta"):
        lstm.bilstm_recurrence_train(
            *(torch.empty(2, 5, 16, device=meta),) * 2,
            *(torch.empty(16, 4, device=meta),) * 2)
    with pytest.raises(ValueError, match="meta"):
        lstm.bilstm_recurrence_backward(
            torch.empty(2, 5, 8, device=meta),
            torch.empty(2, 2, 5, 16, device=meta),
            torch.empty(2, 2, 5, 4, device=meta),
            *(torch.empty(16, 4, device=meta),) * 2)
    assert LAUNCHES == before


def test_bucketed_cases_refuse_other_devices():
    """K1 center=False, K3 with valid_t and K4 with lengths: the same
    rule, plain only on the CPU."""
    meta = torch.device("meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        stft.stft_cat(torch.empty(2, 40796, device=meta), center=False)
    with pytest.raises(ValueError, match="meta"):
        stft.crm_istft(torch.empty(2, 256, 512, device=meta),
                       torch.empty(2, 256, 512, device=meta),
                       valid_t=torch.ones(2, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="meta"):
        lstm.bilstm_recurrence(*(torch.empty(2, 5, 16, device=meta),) * 2,
                               *(torch.empty(16, 4, device=meta),) * 2,
                               torch.ones(2, dtype=torch.int64, device=meta))
    assert LAUNCHES == before


def test_int8_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    before = dict(LAUNCHES)
    x = torch.empty(2, 16, 16, 32, dtype=torch.int8, device=meta)
    w = torch.empty(8, 64, dtype=torch.int8, device=meta)
    v = torch.empty(8, device=meta)
    with pytest.raises(ValueError, match="meta"):
        int8_gemm.int8_matmul(torch.empty(32, 64, dtype=torch.int8, device=meta),
                              torch.empty(64, 8, dtype=torch.int8, device=meta))
    with pytest.raises(ValueError, match="meta"):
        int8_conv.conv_same_int8(x, w, v, v, (1, 1), (1, 1))
    with pytest.raises(ValueError, match="meta"):
        int8_conv.inpaint_conv_int8(x, w, v, v, torch.empty(1, device=meta),
                                    "down", 1, 1, 1)
    # with valid_t: refused too, and a valid_t on another device than
    # the input, of another shape or of a float type raises
    vt = torch.ones(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="meta"):
        int8_conv.conv_same_int8(x, w, v, v, (1, 1), (1, 1), valid_t=vt)
    with pytest.raises(ValueError, match="meta"):
        int8_conv.inpaint_conv_int8(x, w, v, v, torch.empty(1, device=meta),
                                    "down", 1, 1, 1, valid_t=vt)
    with pytest.raises(ValueError, match="valid_t on cpu"):
        int8_conv._valid_arg("conv_same_int8", vt, x)
    for bad in (torch.ones(3, dtype=torch.int64, device=meta),
                torch.ones(2, 1, dtype=torch.int64, device=meta),
                torch.ones(2, device=meta)):
        with pytest.raises(ValueError, match="integer"):
            int8_conv._valid_arg("inpaint_conv_int8", bad, x)
    assert LAUNCHES == before


def test_k6_router_covers_the_reference_trunks():
    """`ExperimentConfig()`'s detector trunk and both ContextAggNet
    encoders: every K6 block goes to the first-layer kernel (block 0),
    the Hopper tile (the blocks between) or the projection kernel (the
    1x1 float32 block), never to the `mma.sync` gather, at the full
    2 s width, the detector's proj at its 60 frames (`time_take`), and
    the eval chain's bucket widths."""
    from sos_tpu_torch.models.quant import _encoder_specs

    cfg = ExperimentConfig()
    d, n = cfg.detector, cfg.denoiser
    trunks = (("detector", d, d.in_channels, d.nf, d.outf),
              ("enc_x", n, 2, n.nf_mixed, n.outf_mixed),
              ("enc_n", n, 2, n.nf_noise, n.outf_noise))
    routed = []
    for name, model, cin0, nf, outf in trunks:
        specs = _encoder_specs(model)
        for width in (178, 256, 1024):
            for i, (ks, dil) in enumerate(specs):
                last = i == len(specs) - 1
                cin, cout = (cin0 if i == 0 else nf), (outf if last else nf)
                w = 60 if last and name == "detector" and width == 178 \
                    else width
                route = int8_conv.conv_same_route(w, cin, cout, ks, dil,
                                                  out_f32=last)
                want = "first" if i == 0 else "proj" if last else "tile"
                assert route == want, (name, i, w, route)
                routed.append(route)
    assert len(routed) == 3 * (12 + 15 + 15)


def _int8(shape, gen, device):
    return torch.randint(-127, 128, shape, generator=gen,
                         dtype=torch.int8).to(device)


def _epilogue_params(cout, taps_cin, gen, device):
    """Weights and a dequant scale that spread outputs over the int8 range."""
    w = _int8((cout, -(-taps_cin // 64) * 64), gen, "cpu")
    w[:, taps_cin:] = 0
    w_s = (torch.rand(cout, generator=gen) + 0.5) * 0.01 / taps_cin ** 0.5
    b = torch.randn(cout, generator=gen) * 20
    return w.to(device), w_s.to(device), b.to(device)


def test_stft_kernels_refuse_other_geometries():
    """K1 and K3 launch a kernel at every STFT geometry (the prime-factor
    instance at n_fft 510, hop 158, win 400, the "fft" instance where the
    transform factors, the generic one elsewhere), so another geometry
    off the CPU is a device error like any other, never the plain
    version; a geometry no STFT has (win > n_fft, hop 0) is refused
    before a launch."""
    meta = torch.device("meta")
    before = dict(LAUNCHES)
    for kw, instance in (({"n_fft": 512}, "fft"), ({"hop_length": 128}, "fft"),
                         ({"win_length": 510}, "fft"),
                         ({"n_fft": 254, "win_length": 254}, "generic")):
        assert stft.kernel_instance(**{**GEOMETRY, **kw}) == instance
        with pytest.raises(ValueError, match="meta"):
            stft.stft_cat(torch.empty(2, 28000, device=meta), **kw)
        with pytest.raises(ValueError, match="meta"):
            stft.crm_istft(torch.empty(2, 178, 512, device=meta),
                           torch.empty(2, 178, 512, device=meta), **kw)
    for kw in ({"win_length": 600}, {"hop_length": 0}):
        with pytest.raises(ValueError, match="needs n_fft"):
            stft.stft_cat(torch.empty(2, 28000, device=meta), **kw)
        with pytest.raises(ValueError, match="needs n_fft"):
            stft.crm_istft(torch.empty(2, 178, 512, device=meta),
                           torch.empty(2, 178, 512, device=meta), **kw)
    assert stft.kernel_instance(**GEOMETRY) == "pfa"
    assert LAUNCHES == before


GEOMETRY = {"n_fft": 510, "hop_length": 158, "win_length": 400}
# other STFT geometries: (n_fft, hop, win) of the generic instances (a
# prime factor above 73: 127, 89) and of the "fft" instances (7 * 73,
# frame pairs of 7 * 73, 2^8, 2^3 * 25)
OTHER_GEOMETRIES = [(254, 64, 254), (178, 64, 178)]
FFT_GEOMETRIES = [(1022, 256, 1022), (511, 158, 400), (512, 128, 512),
                  (400, 100, 300)]


def _spiky(n_fft, device, gen, rows=5):
    y = (torch.randn(rows, 14097, generator=gen) * 0.3).to(device)
    y[:, :n_fft // 2:17] += 3.0
    y[:, -(n_fft // 2)::19] -= 3.0
    return y


def _stft_case(device, n_fft, hop, win, center, instance):
    y = _spiky(n_fft, device, torch.Generator().manual_seed(n_fft + hop))
    key = f"stft_{instance}" + ("" if center else "_center_false")
    before = dict(LAUNCHES)
    got = stft.stft_cat(y, n_fft, hop, win, center=center)
    assert stft.kernel_instance(n_fft, hop, win) == instance
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES
            if LAUNCHES[k] != before[k]} == {key: 1}
    torch.testing.assert_close(
        got, stft.stft_cat_plain(y, n_fft, hop, win, center=center),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", OTHER_GEOMETRIES)
@pytest.mark.parametrize("center", [True, False])
def test_stft_generic_kernel_matches_plain(cuda_device, n_fft, hop, win,
                                           center):
    """K1's generic instance (the dense product over the float64-built
    table) at geometries the "fft" instance does not take, centered
    (spikes where the reflect pad reads) and over a pre-padded buffer."""
    _stft_case(cuda_device, n_fft, hop, win, center, "generic")


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", FFT_GEOMETRIES)
@pytest.mark.parametrize("center", [True, False])
def test_stft_fft_kernel_matches_plain(cuda_device, n_fft, hop, win, center):
    """K1's "fft" instance (csrc/stft_fft.cu) at the geometries whose
    transform factors, centered and over a pre-padded buffer."""
    _stft_case(cuda_device, n_fft, hop, win, center, "fft")


# odd n_fft at lengths the hop divides: the centered count is
# 1 + (L - 1) // hop, one frame fewer than 1 + L // hop; the second case
# reflects the whole signal but one sample (L = n_fft // 2 + 1). n_fft 511
# runs the "fft" instance on frame pairs, 237 (3 * 79) the generic one
ODD_N_FFT_CASES = [((511, 100, 400), 28000), ((511, 64, 511), 256),
                   ((237, 100, 200), 28000)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry,length", ODD_N_FFT_CASES)
def test_stft_generic_kernel_odd_n_fft_frame_count(cuda_device, geometry,
                                                   length):
    """K1 (its "fft" or generic instance) frames an odd-n_fft centered
    STFT as the plain version does (same shape, same values) where the
    hop divides the length."""
    n_fft, hop, win = geometry
    gen = torch.Generator().manual_seed(length)
    y = (torch.randn(3, length, generator=gen) * 0.3).to(cuda_device)
    got = stft.stft_cat(y, n_fft, hop, win)
    assert got.shape[1] == stft.stft_num_frames(length, n_fft, hop) == \
        1 + (length - 1) // hop
    torch.testing.assert_close(got, stft.stft_cat_plain(y, n_fft, hop, win),
                               atol=1e-4, rtol=1e-4)


def _crm_istft_case(device, n_fft, hop, win, valid, instance):
    gen = torch.Generator().manual_seed(n_fft * hop)
    spec = stft.stft_cat_plain(
        (torch.randn(4, 14097, generator=gen) * 0.3).to(device),
        n_fft, hop, win)
    crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(device)
    crm.view(-1)[::7] = 0.01
    crm.view(-1)[3::7] = 0.99
    frames = spec.shape[1]
    valid_t = (torch.tensor([frames, 1, 2, frames // 2], dtype=torch.int64)
               .to(device) if valid else None)
    key = f"crm_istft_{instance}" + ("_valid_t" if valid else "")
    before = dict(LAUNCHES)
    got = stft.crm_istft(crm, spec, n_fft, hop, win, valid_t=valid_t)
    assert stft.kernel_instance(n_fft, hop, win) == instance
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES
            if LAUNCHES[k] != before[k]} == {key: 1}
    assert got.shape == (4, (frames - 1) * hop + n_fft % 2)
    torch.testing.assert_close(
        got, stft.crm_istft_plain(crm, spec, n_fft, hop, win, valid_t),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", OTHER_GEOMETRIES)
@pytest.mark.parametrize("valid", [False, True])
def test_crm_istft_generic_kernel_matches_plain(cuda_device, n_fft, hop, win,
                                                valid):
    """K3's generic instance at geometries the "fft" instance does not
    take, with and without a valid frame count per row."""
    _crm_istft_case(cuda_device, n_fft, hop, win, valid, "generic")


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", FFT_GEOMETRIES)
@pytest.mark.parametrize("valid", [False, True])
def test_crm_istft_fft_kernel_matches_plain(cuda_device, n_fft, hop, win,
                                            valid):
    """K3's "fft" instance (csrc/crm_istft_fft.cu; odd n_fft: frame pairs
    and one more sample), with and without a valid frame count per row."""
    _crm_istft_case(cuda_device, n_fft, hop, win, valid, "fft")


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win,instance", [
    (510, 158, 400, "pfa"), *[(*g, "fft") for g in FFT_GEOMETRIES],
    *[(*g, "generic") for g in OTHER_GEOMETRIES]])
def test_crm_istft_valid_t_kernels_zero_past_the_reach(cuda_device, n_fft,
                                                       hop, win, instance):
    """K3's valid_t instances at a 256-frame bucket, rows of the whole
    bucket, 2, 1 and 0 frames and some between: within the plain
    version's atol 1e-4 + rtol 1e-4 on the samples a caller keeps, j <
    (valid_t - 1) hop (past them only the tail of the last frame reaches
    a sample, and the divide by its squared window value amplifies fp32
    rounding: chip_smoke.py `within_valid`), and exactly 0 from each
    row's live reach on (the last sample its last live frame reaches),
    where their dead blocks store zeros without computing."""
    bucket = 256
    gen = torch.Generator().manual_seed(n_fft + 7)
    spec = (torch.randn(6, bucket, 2 * (n_fft // 2 + 1), generator=gen)
            * 0.3).to(cuda_device)
    crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(cuda_device)
    valid_t = torch.tensor([bucket, 2, 1, 0, 131, 57]).to(cuda_device)
    key = ("crm_istft_valid_t" if instance == "pfa"
           else f"crm_istft_{instance}_valid_t")
    before = LAUNCHES[key]
    got = stft.crm_istft(crm, spec, n_fft, hop, win, valid_t=valid_t)
    assert LAUNCHES[key] == before + 1
    ref = stft.crm_istft_plain(crm, spec, n_fft, hop, win, valid_t)
    for b, v in enumerate(valid_t.tolist()):
        kept = max(0, (v - 1) * hop)
        torch.testing.assert_close(got[b, :kept], ref[b, :kept], atol=1e-4,
                                   rtol=1e-4)
        reach = max(0, (v - 1) * hop + n_fft - n_fft // 2) if v else 0
        assert not got[b, reach:].any(), (b, v)


STFT_SHAPES = [(b, n) for b in (1, 3, 5) for n in (28000, 14000 + 97)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length", STFT_SHAPES)
def test_stft_kernel_matches_plain(cuda_device, batch, length):
    y = torch.randn(batch, length, device=cuda_device) * 0.3
    y[:, :255:17] += 3.0  # spikes where the reflect padding reads
    y[:, -255::19] -= 3.0
    torch.testing.assert_close(stft.stft_cat(y), stft.stft_cat_plain(y),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,view", [
    (3, 28000, "contiguous"), (128, 28000, "contiguous"),
    (3, 14097, "contiguous"), (3, 28000, "misaligned"),
    (9, 14097, "misaligned")])
def test_mask_gate_kernel_exact(cuda_device, batch, length, view):
    """K2 on its four-sample route (L % 4 == 0; a misaligned view is
    copied to aligned rows) and its scalar route (L 14,097, 30 frames),
    exact."""
    y = torch.randn(batch, length, device=cuda_device)
    frames = 30 * length // 14000
    bits = (torch.rand(batch, frames, device=cuda_device) < 0.5).float()
    before = LAUNCHES["mask_gate"]
    got = mixing.mask_gate(_misaligned(y) if view == "misaligned" else y,
                           bits, RATIO)
    assert LAUNCHES["mask_gate"] == before + 1
    assert torch.equal(got, mixing.mask_gate_plain(y, bits, RATIO))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,view", [
    (15, 28000, "contiguous"), (40, 28000, "contiguous"),
    (3, 14097, "contiguous"), (9, 28000, "misaligned")])
def test_mask_gate_complement_kernel_exact(cuda_device, batch, length, view):
    """K2's complement instance, `x * (1 - mask)`, at the training
    batches (15 and 40 clips) and on both routes, exact."""
    y = torch.randn(batch, length, device=cuda_device)
    frames = 30 * length // 14000
    bits = (torch.rand(batch, frames, device=cuda_device) < 0.5).float()
    before = dict(LAUNCHES)
    got = mixing.mask_gate(_misaligned(y) if view == "misaligned" else y,
                           bits, RATIO, complement=True)
    assert LAUNCHES["mask_gate_complement"] == before["mask_gate_complement"] + 1
    assert LAUNCHES["mask_gate"] == before["mask_gate"]
    assert torch.equal(got, mixing.mask_gate_plain(y, bits, RATIO,
                                                   complement=True))
    assert torch.equal(got + mixing.mask_gate(y, bits, RATIO), y)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seconds,extra,min_run,complement", [
    (8, 60, 0, 5, False), (2, 600, 0, 5, True), (3, 8, 3, 5, False),
    (5, 2, 0, 600, False), (3, 8, 0, 600, True), (2, 8, 1, 600, False),
    (4, 8, 0, 1, False)])
def test_mask_gate_long_and_despeckle_kernel_exact(cuda_device, batch,
                                                   seconds, extra, min_run,
                                                   complement):
    """K2 past the dense matrices' 2^24 elements (the gather maps' table,
    18,000 frames at 600 s) and its generic-despeckle instance
    (`despeckle_min_run` 600 > the frame body), gate and complement, on
    both routes, exactly."""
    length, frames = seconds * 14000 + extra, seconds * 30
    y = torch.randn(batch, length, device=cuda_device)
    bits = (torch.rand(batch, frames, device=cuda_device) < 0.5).float()
    key = ("mask_gate_despeckle" if min_run == 600 else "mask_gate_long"
           if frames * length > mixing._DENSE_MASK_MAX_ELEMS else "mask_gate")
    before = LAUNCHES[key]
    got = mixing.mask_gate(y, bits, RATIO, min_run, complement=complement)
    assert LAUNCHES[key] == before + 1
    assert torch.equal(got, mixing.mask_gate_plain(y, bits, RATIO, min_run,
                                                   complement=complement))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length", STFT_SHAPES)
def test_crm_istft_kernel_matches_plain(cuda_device, batch, length):
    spec = stft.stft_cat_plain(
        torch.randn(batch, length, device=cuda_device) * 0.3)
    crm = torch.rand(spec.shape, device=cuda_device) * 0.98 + 0.01
    crm.view(-1)[::7] = 0.01
    crm.view(-1)[3::7] = 0.99
    before = LAUNCHES["crm_istft"]
    got = stft.crm_istft(crm, spec)
    assert LAUNCHES["crm_istft"] == before + 1
    torch.testing.assert_close(got, stft.crm_istft_plain(crm, spec),
                               atol=1e-4, rtol=1e-4)


def _bucket_buffers(lengths, bucket_t, device):
    """Reflect-padded, zero-extended buffers as the bucketed predictors
    build them, for frame bucket `bucket_t`."""
    need = (bucket_t - 1) * 158 + 510
    out = torch.zeros(len(lengths), need)
    for row, n in enumerate(lengths):
        y = torch.randn(1, 1, n) * 0.3
        r = torch.nn.functional.pad(y, (255, 255), mode="reflect")[0, 0]
        out[row, :min(len(r), need)] = r[:need]
    return out.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_t,rows", [(256, 3), (1024, 5), (1024, 128)])
def test_stft_kernel_center_false_matches_plain(cuda_device, bucket_t, rows):
    """K1 over pre-padded buffers: frame f starts at f * 158, T = 1 +
    (L - 510) // 158, no reflect (rows of 1 s up to the full bucket)."""
    gen = torch.Generator().manual_seed(bucket_t + rows)
    full = (bucket_t - 1) * 158
    lengths = torch.randint(600, full + 1, (rows,), generator=gen).tolist()
    lengths[0] = full
    y = _bucket_buffers(lengths, bucket_t, cuda_device)
    before = dict(LAUNCHES)
    got = stft.stft_cat(y, center=False)
    assert LAUNCHES["stft_center_false"] == before["stft_center_false"] + 1
    assert LAUNCHES["stft"] == before["stft"]
    assert got.shape == (rows, bucket_t, 512)
    torch.testing.assert_close(got, stft.stft_cat_plain(y, center=False),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_t,rows", [(256, 4), (1024, 16)])
def test_crm_istft_kernel_valid_t_matches_plain(cuda_device, bucket_t, rows):
    """K3 with a valid frame count per row: the full bucket, 1 and 2
    frames, and counts drawn between; row b drops its frames >= valid_t
    and divides by their envelope alone."""
    gen = torch.Generator().manual_seed(bucket_t)
    spec = stft.stft_cat_plain(
        (torch.randn(rows, (bucket_t - 1) * 158, generator=gen) * 0.3)
        .to(cuda_device))
    crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(cuda_device)
    valid_t = torch.randint(2, bucket_t + 1, (rows,), generator=gen)
    valid_t[:3] = torch.tensor([bucket_t, 1, 2])
    valid_t = valid_t.to(cuda_device)
    before = dict(LAUNCHES)
    got = stft.crm_istft(crm, spec, valid_t=valid_t)
    assert LAUNCHES["crm_istft_valid_t"] == before["crm_istft_valid_t"] + 1
    assert LAUNCHES["crm_istft"] == before["crm_istft"]
    torch.testing.assert_close(
        got, stft.crm_istft_plain(crm, spec, valid_t=valid_t),
        atol=1e-4, rtol=1e-4)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def test_aligned16_clones_only_misaligned_views():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    assert aligned16(x) is x
    view = _misaligned(x)
    assert view.data_ptr() % 16 == 4
    out = aligned16(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, x)


@pytest.mark.parametrize("view", ["transposed", "column slice"])
def test_aligned16_copies_strided_views_to_rows(view):
    """The TMA kernels (K5, K6) read rows a fixed number of bytes apart:
    `aligned16` hands them a strided view as contiguous rows."""
    x = torch.arange(-64, 64, dtype=torch.int8).reshape(8, 16)
    v = x.t() if view == "transposed" else x[:, 4:12]
    assert not v.is_contiguous()
    out = aligned16(v)
    assert out.is_contiguous() and out.data_ptr() % 16 == 0
    assert torch.equal(out, v)


@pytest.mark.cuda
def test_crm_istft_kernel_takes_misaligned_views(cuda_device):
    spec = stft.stft_cat_plain(torch.randn(2, 28000, device=cuda_device) * 0.3)
    crm = torch.rand(spec.shape, device=cuda_device) * 0.98 + 0.01
    got = stft.crm_istft(_misaligned(crm), _misaligned(spec))
    torch.testing.assert_close(got, stft.crm_istft_plain(crm, spec),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden,masked", [
    (4, 60, 100, False), (4, 178, 200, False), (4, 20, 8, True),
    (128, 60, 100, False), (128, 178, 200, False), (128, 178, 200, True),
    (9, 178, 200, False), (9, 60, 100, True), (3, 12, 16, True),
    (160, 12, 200, True), (16, 1024, 200, True), (16, 384, 100, True),
    (40, 60, 100, True)])
def test_bilstm_kernel_matches_plain(cuda_device, batch, steps, hidden,
                                     masked):
    """K4 at both main-path cases (B 128: H 100 over clusters of 2, H
    200 over clusters of 8 in waves of clusters), with per-row lengths
    (`masked`: the full T, 1 step and lengths between, as the bucketed
    predictors give them), with a ragged last tile, and at each rows a
    block of the H 100 and H 200 classes (B 40 at H 100: 4 rows over
    clusters of 4)."""
    gen = torch.Generator(device=cuda_device).manual_seed(batch + hidden)
    xp_f, xp_b = (torch.randn(batch, steps, 4 * hidden, device=cuda_device,
                              generator=gen) for _ in range(2))
    w_f, w_b = ((torch.rand(4 * hidden, hidden, device=cuda_device,
                            generator=gen) * 2 - 1) / hidden ** 0.5
                for _ in range(2))
    lengths = None
    if masked:
        lengths = torch.randint(1, steps + 1, (batch,), device=cuda_device,
                                generator=gen)
        lengths[0], lengths[-1] = steps, 1
    key = "bilstm" if lengths is None else "bilstm_lengths"
    before = LAUNCHES[key]
    got = lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)
    assert LAUNCHES[key] == before + 1
    torch.testing.assert_close(
        got, lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths),
        atol=5e-5, rtol=0)
    if masked:
        for b, n in enumerate(lengths.tolist()):
            assert not got[b, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden,longest", [
    *[(b, t, h, top) for b in (8, 16) for t, h in ((1024, 200), (384, 100))
      for top in ("T", "0.6 T", "1")],
    (15, 384, 200, "0.6 T"), (9, 1024, 100, "T")])
def test_bilstm_lengths_kernel_matches_plain(cuda_device, batch, steps,
                                             hidden, longest):
    """K4 with per-row lengths at the eval chain's batches (8, 16) and
    phase 3's shapes, the longest row at T, at 0.6 T and every row one
    step (each tile walks to its longest row and writes zeros past it),
    and ragged last tiles (B 15 and 9): within atol 5e-5 of the plain
    version, padding steps exactly 0. int64 lengths, as `BiLSTM` passes
    them, and int32."""
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, batch + steps)
    top = {"T": steps, "0.6 T": int(0.6 * steps), "1": 1}[longest]
    gen = torch.Generator().manual_seed(steps)
    lengths = torch.randint(1, top + 1, (batch,), generator=gen)
    lengths[batch // 2] = top
    with exact_fp32():
        ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
    for dtype in (torch.int64, torch.int32):
        before = LAUNCHES["bilstm_lengths"]
        got = lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b,
                                     lengths.to(cuda_device, dtype))
        assert LAUNCHES["bilstm_lengths"] == before + 1
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)
        for b, n in enumerate(lengths.tolist()):
            assert not got[b, n:].any()


@pytest.mark.cuda
def test_bilstm_lengths_kernel_replays_in_a_cuda_graph(cuda_device):
    """K4 with per-row lengths captured into a CUDA graph, replayed after
    new lengths are written into the same tensor: each replay matches the
    plain version at the new lengths (its longest row moves too). So the
    kernel reads the lengths on the card at run time, and the wrapper
    syncs nowhere (a sync inside a capture raises). An expanded scalar
    length (stride 0, `BiLSTM(valid_len=int)`) reads the same."""
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, 8, 384, 200, 3)
    lengths = torch.tensor([384, 200, 17, 1, 384, 90, 300, 5],
                           device=cuda_device)

    def k4():
        return lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds, allocator pools
        k4()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["bilstm_lengths"]
    with torch.cuda.graph(graph):
        out = k4()
    assert LAUNCHES["bilstm_lengths"] == before + 1
    for new in ([384, 200, 17, 1, 384, 90, 300, 5], [3, 1, 2, 230, 1, 7, 0, 9],
                [1] * 8, [384] * 8):
        lengths.copy_(torch.tensor(new))
        graph.replay()
        torch.cuda.synchronize()
        with exact_fp32():
            ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
        torch.testing.assert_close(out, ref, atol=5e-5, rtol=0)
        for b, n in enumerate(new):
            assert not out[b, n:].any(), new
    one = torch.tensor(100, device=cuda_device).expand(8)
    assert one.stride(0) == 0
    with exact_fp32():
        torch.testing.assert_close(
            lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b, one),
            lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, one),
            atol=5e-5, rtol=0)


class _OverSizedPlan(lstm.RecurrencePlan):
    """A register plan asking for more shared memory than a block of the
    card may take."""

    @property
    def smem_bytes(self) -> int:
        return lstm.SMEM_LIMIT + 1024


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["no instance", "over the card"])
def test_bilstm_kernel_refuses_plans_the_card_cannot_run(cuda_device,
                                                         monkeypatch, kind):
    """A plan csrc/bilstm.cu has no instance for (a cluster of 16 at 4
    rows) and one whose blocks the card cannot hold raise, launch
    nothing, and never fall back to another layout."""
    import dataclasses
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, 16, 20, 200, 1)
    plan = lstm.recurrence_plan(16, 200)
    if kind == "no instance":
        bad = dataclasses.replace(plan, cluster=16,
                                  units=lstm._unit_runs(200, 16))
    else:
        bad = _OverSizedPlan(**{f.name: getattr(plan, f.name)
                                for f in dataclasses.fields(plan)})
    monkeypatch.setattr(lstm, "recurrence_plan", lambda b, h: bad)
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="sos_bilstm: CUDA error"):
        lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b)
    assert LAUNCHES == before


def _recurrence_inputs(device, batch, steps, hidden, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    xp_f, xp_b = (torch.randn(batch, steps, 4 * hidden, device=device,
                              generator=gen) for _ in range(2))
    w_f, w_b = ((torch.rand(4 * hidden, hidden, device=device,
                            generator=gen) * 2 - 1) / hidden ** 0.5
                for _ in range(2))
    return xp_f, xp_b, w_f, w_b


TRAIN_SHAPES = [(15, 60, 100), (40, 178, 200), (2, 60, 100), (2, 178, 200),
                (9, 12, 8), (3, 20, 4), (5, 30, 200), (15, 178, 200)]
# K4b's (cluster, rows) at the training shapes: the detector, the
# denoiser, the joint step's denoiser
BACKWARD_PLANS = {(15, 60, 100): (4, 1), (40, 178, 200): (8, 8),
                  (15, 178, 200): (8, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", TRAIN_SHAPES)
def test_bilstm_train_kernel_matches_plain(cuda_device, batch, steps, hidden):
    """K4's training instance: h bit-identical to the inference
    instance's; c and the gates one step from the kernel's own h (each
    step's arithmetic alone) within 1e-6, and against the plain training
    forward within K4's 5e-5."""
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, batch + hidden)
    before = dict(LAUNCHES)
    out, c, gates = lstm.bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
    assert LAUNCHES["bilstm_train"] == before["bilstm_train"] + 1
    assert LAUNCHES["bilstm"] == before["bilstm"]
    assert torch.equal(out, lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b))
    ref_out, ref_c, ref_gates = lstm.bilstm_recurrence_train_plain(
        xp_f, xp_b, w_f, w_b)
    for got, ref in ((out, ref_out), (c, ref_c), (gates, ref_gates)):
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)
    with exact_fp32():
        step_c, step_gates = lstm.bilstm_step_states(xp_f, xp_b, w_f, w_b,
                                                     out, c)
    torch.testing.assert_close(gates, step_gates, atol=1e-6, rtol=0)
    torch.testing.assert_close(c, step_c, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", TRAIN_SHAPES)
def test_bilstm_backward_kernel_matches_plain(cuda_device, batch, steps,
                                              hidden):
    """K4b against its plain version on the same saved state (the
    training instance's), both directions: d xp within 5e-5; at the
    three training shapes, the launch plan's (cluster, rows)."""
    plan = lstm.backward_plan(batch, hidden)
    assert (plan.cluster, plan.bt) == BACKWARD_PLANS.get(
        (batch, steps, hidden), (plan.cluster, plan.bt))
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, 7 * batch + hidden)
    _, c, gates = lstm.bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
    dout = torch.randn(batch, steps, 2 * hidden, device=cuda_device)
    before = LAUNCHES["bilstm_bwd"]
    got = lstm.bilstm_recurrence_backward(dout, gates, c, w_f, w_b)
    assert LAUNCHES["bilstm_bwd"] == before + 1
    with exact_fp32():
        ref = lstm.bilstm_recurrence_backward_plain(dout, gates, c, w_f, w_b)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=5e-5, rtol=0)


@pytest.mark.cuda
def test_bilstm_gradients_card_match_cpu(cuda_device):
    """`BiLSTM` with a gradient on the card (K4's training instance, K4b
    and the dW_hh product) against the same module on the CPU: every
    gradient within 1e-4 of its tensor's max |g|."""
    torch.manual_seed(0)
    model = lstm.BiLSTM(24, 200)
    model.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(2, 178, 24)
    weight = torch.randn(2, 178, 400)
    grads = {}
    for dev in ("cpu", cuda_device):
        m = lstm.BiLSTM(24, 200).to(dev)
        m.load_state_dict(model.state_dict())
        xt = x.detach().to(dev).clone().requires_grad_(True)
        before = dict(LAUNCHES)
        with exact_fp32():
            (m(xt) * weight.to(dev)).sum().backward()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if dev != "cpu":
            assert launched["bilstm_train"] == 1 and launched["bilstm_bwd"] == 1
        grads[str(dev)] = {n: p.grad.cpu() for n, p in m.named_parameters()}
        grads[str(dev)]["x"] = xt.grad.cpu()
    for name, ref in grads["cpu"].items():
        got = grads[str(cuda_device)][name]
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale, name


@pytest.mark.cuda
def test_bilstm_kernel_refuses_hidden_past_its_plan(cuda_device):
    """Past the register plans (H 224) K4 refuses nothing: H 300 takes
    the wide route (one launch, counted apart) and matches the plain
    version."""
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, 2, 5, 300, 9)
    before = dict(LAUNCHES)
    got = lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES
            if LAUNCHES[k] != before[k]} == {"bilstm_wide": 1}
    with exact_fp32():
        ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)


# the wide route (csrc/bilstm_wide.cu): phase 3's shapes (B 16, T 178 at
# H 256 and 512), rows a task of 2 and H % 4 != 0 (229), rows staged in
# chunks (B 40 at H 512: K4b stages 16 rows at a time), and columns staged
# in chunks (H 5000 forward, H 2048 backward: rows past the shared budget)
WIDE_SHAPES = [(16, 178, 256), (16, 178, 512), (2, 12, 229), (40, 20, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch,steps,hidden", WIDE_SHAPES + [(8, 3, 5000)])
def test_bilstm_wide_kernel_matches_plain(cuda_device, batch, steps, hidden,
                                          masked):
    """K4 on the wide route, without and with per-row lengths (the
    longest row at 0.6 T, one row of 1 step): within K4's atol 5e-5 of
    the plain version, padding steps exactly 0."""
    plan = lstm.recurrence_plan(batch, hidden)
    assert isinstance(plan, lstm.WidePlan)
    assert len(plan.column_chunks()) == (2 if hidden == 5000 else 1)
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, batch + hidden)
    lengths = None
    if masked:
        gen = torch.Generator().manual_seed(hidden)
        lengths = torch.randint(1, max(2, int(0.6 * steps)) + 1, (batch,),
                                generator=gen)
        lengths[0], lengths[-1] = max(1, int(0.6 * steps)), 1
        lengths = lengths.to(cuda_device)
    key = "bilstm_wide" if lengths is None else "bilstm_lengths_wide"
    before = dict(LAUNCHES)
    got = lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES
            if LAUNCHES[k] != before[k]} == {key: 1}
    with exact_fp32():
        ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)
    if masked:
        for b, n in enumerate(lengths.tolist()):
            assert not got[b, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", WIDE_SHAPES)
def test_bilstm_wide_train_kernel_matches_plain(cuda_device, batch, steps,
                                                hidden):
    """K4's training instance on the wide route: h bit-identical to the
    wide inference instance's; c and the gates within 1e-6 of one step
    from the kernel's own state and within 5e-5 of the plain training
    forward."""
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, batch + hidden)
    before = dict(LAUNCHES)
    out, c, gates = lstm.bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
    assert LAUNCHES["bilstm_train_wide"] == before["bilstm_train_wide"] + 1
    assert torch.equal(out, lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b))
    with exact_fp32():
        refs = lstm.bilstm_recurrence_train_plain(xp_f, xp_b, w_f, w_b)
        step_c, step_gates = lstm.bilstm_step_states(xp_f, xp_b, w_f, w_b,
                                                     out, c)
    for got, ref in zip((out, c, gates), refs):
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)
    torch.testing.assert_close(gates, step_gates, atol=1e-6, rtol=0)
    torch.testing.assert_close(c, step_c, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,hidden", WIDE_SHAPES + [(8, 3, 2048)])
def test_bilstm_wide_backward_kernel_matches_plain(cuda_device, batch, steps,
                                                   hidden):
    """K4b on the wide route against its plain version on the same saved
    state: d xp within 5e-5."""
    plan = lstm.backward_plan(batch, hidden)
    assert isinstance(plan, lstm.WidePlan) and plan.backward
    xp_f, xp_b, w_f, w_b = _recurrence_inputs(cuda_device, batch, steps,
                                              hidden, 7 * batch + hidden)
    _, c, gates = lstm.bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
    dout = torch.randn(batch, steps, 2 * hidden, device=cuda_device)
    before = LAUNCHES["bilstm_bwd_wide"]
    got = lstm.bilstm_recurrence_backward(dout, gates, c, w_f, w_b)
    assert LAUNCHES["bilstm_bwd_wide"] == before + 1
    with exact_fp32():
        ref = lstm.bilstm_recurrence_backward_plain(dout, gates, c, w_f, w_b)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=5e-5, rtol=0)


@pytest.mark.cuda
def test_bilstm_wide_gradients_card_match_cpu(cuda_device):
    """`BiLSTM(24, 256)` with a gradient on the card (the wide route's
    training instance, K4b and the dW_hh product) against the same module
    on the CPU: every gradient within 1e-4 of its tensor's max |g|."""
    model = lstm.BiLSTM(24, 256)
    model.reset_parameters(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    x, weight = torch.randn(2, 60, 24, generator=gen), torch.randn(
        2, 60, 512, generator=gen)
    grads = {}
    for dev in ("cpu", cuda_device):
        m = lstm.BiLSTM(24, 256).to(dev)
        m.load_state_dict(model.state_dict())
        xt = x.detach().to(dev).clone().requires_grad_(True)
        before = dict(LAUNCHES)
        with exact_fp32():
            (m(xt) * weight.to(dev)).sum().backward()
        if dev != "cpu":
            assert LAUNCHES["bilstm_train_wide"] == before["bilstm_train_wide"] + 1
            assert LAUNCHES["bilstm_bwd_wide"] == before["bilstm_bwd_wide"] + 1
        grads[str(dev)] = {n: p.grad.cpu() for n, p in m.named_parameters()}
        grads[str(dev)]["x"] = xt.grad.cpu()
    for name, ref in grads["cpu"].items():
        got = grads[str(cuda_device)][name]
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), name


def test_kernel_wrappers_launch_through_on_device():
    """K1-K7's wrappers (and K4b's) take the current stream through
    `on_device`, not through `torch.cuda.current_stream` and
    `torch.cuda.device`. K4's two instances launch through one helper."""
    import inspect
    for fn in (lstm.bilstm_recurrence, lstm.bilstm_recurrence_train):
        assert "_recurrence_on_card(" in inspect.getsource(fn), fn.__name__
    for fn in (stft.stft_cat, mixing.mask_gate, stft.crm_istft,
               lstm._recurrence_on_card, lstm.bilstm_recurrence_backward,
               int8_gemm.int8_matmul_nt,
               int8_conv.conv_same_int8, int8_conv.inpaint_conv_int8):
        src = inspect.getsource(fn)
        assert "on_device(" in src, fn.__name__
        assert "current_stream" not in src and "torch.cuda.device(" not in src


def _tiny_cfg():
    ks, dils = ((1, 7), (5, 5)), ((1, 1), (2, 2))
    return ExperimentConfig(
        detector=DetectorModelConfig(nf=4, outf=2, kernel_sizes=ks,
                                     dilations=dils, lstm_hidden=4,
                                     fc_hidden=4),
        denoiser=DenoiserModelConfig(nf_mixed=8, nf_noise=4, outf_mixed=8,
                                     outf_noise=4, kernel_sizes=ks,
                                     dilations=dils, lstm_hidden=8,
                                     fc_hidden=16, inpaint_ch=(4, 6, 8)),
        data=DataConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", [None, (256, 1024)])
def test_small_predictors_card_match_cpu(cuda_device, buckets):
    """The full-utterance predictors at small widths, exact and bucketed
    (batched, with a repeated last row), card against CPU, an utterance
    past 6.3 s among them; the bucketed run goes through K1 center=False,
    K3 valid_t and K4 with per-row lengths."""
    from sos_tpu_torch.infer import DenoiserPredictor, DetectorPredictor

    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(1)
    det = init_state_dict(SilenceDetector(cfg.detector), gen)
    den = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    wavs = [(torch.randn(n, generator=gen) * 0.2).numpy()
            for n in (28000, 20000, 100000)]
    frames = [int(len(w) / 14000 * 30) for w in wavs]
    bits = ["".join("01"[(j // 7) % 2] for j in range(n)) for n in frames]
    out = {}
    for device in ("cpu", cuda_device):
        d = DetectorPredictor(cfg, det, buckets=buckets, device=device)
        n = DenoiserPredictor(cfg, den, buckets=buckets, device=device)
        before = dict(LAUNCHES)
        out[str(device)] = (d.predict_batch(wavs, frames, batch_size=2),
                            n.denoise_batch(wavs, bits, batch_size=2))
        if device != "cpu":
            cases = (("stft", "crm_istft", "bilstm") if buckets is None else
                     ("stft_center_false", "crm_istft_valid_t",
                      "bilstm_lengths"))
            assert all(LAUNCHES[k] > before[k] for k in cases)
    (cpu_det, cpu_den), (card_det, card_den) = out["cpu"], out["cuda"]
    for (_, c), (_, g) in zip(cpu_det, card_det):
        torch.testing.assert_close(torch.from_numpy(g), torch.from_numpy(c),
                                   atol=1e-4, rtol=0)
    for c, g in zip(cpu_den, card_den):
        for key in c:
            torch.testing.assert_close(torch.from_numpy(g[key]),
                                       torch.from_numpy(c[key]),
                                       atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
def test_small_int8_predictors_card_match_cpu(cuda_device, tmp_path):
    """The int8 predictors bucketed and batched at small widths, card
    against CPU with one scale file: through K6's and K7's valid_t cases
    (the small InpaintNet's Couts take K7's gather route)."""
    import json

    from sos_tpu_torch.infer import DenoiserPredictor, DetectorPredictor

    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(2)
    det = init_state_dict(SilenceDetector(cfg.detector), gen)
    den = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    wavs = [(torch.randn(n, generator=gen) * 0.2).numpy()
            for n in (28000, 20000, 40000)]
    frames = [int(len(w) / 14000 * 30) for w in wavs]
    bits = ["".join("01"[(j // 7) % 2] for j in range(n)) for n in frames]
    path = tmp_path / "int8_calibration.json"
    host_d = DetectorPredictor(cfg, det, profile="int8", device="cpu")
    host_n = DenoiserPredictor(cfg, den, profile="int8", device="cpu")
    host_d.predict_waveform(wavs[0], frames[0])  # calibrates
    host_n.denoise_waveform(wavs[0], bits[0])
    path.write_text(json.dumps({
        "detector": host_d._quant.calibration_state(),
        "denoiser": host_n._quant.calibration_state()}))
    out = {}
    for device in ("cpu", cuda_device):
        d = DetectorPredictor(cfg, det, buckets=(256, 512), profile="int8",
                              calibration_path=str(path), device=device)
        n = DenoiserPredictor(cfg, den, buckets=(256, 512), profile="int8",
                              calibration_path=str(path), device=device)
        before = dict(LAUNCHES)
        out[str(device)] = (d.predict_batch(wavs, frames, batch_size=2),
                            n.denoise_batch(wavs, bits, batch_size=2))
        if device != "cpu":
            assert all(LAUNCHES[k] > before[k] for k in (
                "int8_conv_valid_t", "int8_inpaint_valid_t",
                "stft_center_false", "crm_istft_valid_t", "bilstm_lengths"))
            assert LAUNCHES["int8_conv"] == before["int8_conv"]
    (cpu_det, cpu_den), (card_det, card_den) = out["cpu"], out["cuda"]
    for (cb, c), (gb, g) in zip(cpu_det, card_det):
        torch.testing.assert_close(torch.from_numpy(g), torch.from_numpy(c),
                                   atol=1e-4, rtol=0)
    for c, g in zip(cpu_den, card_den):
        for key in c:
            torch.testing.assert_close(torch.from_numpy(g[key]),
                                       torch.from_numpy(c[key]),
                                       atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_small_pipeline_card_matches_cpu(cuda_device):
    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(0)
    det = init_state_dict(SilenceDetector(cfg.detector), gen)
    den = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    x = torch.randn(2, 28000, generator=gen) * 0.2
    bits = (torch.rand(2, 60, generator=gen) < 0.5).float()
    card = FusedDenoisePipeline(cfg, det, den, device=cuda_device)
    host = FusedDenoisePipeline(cfg, det, den, device="cpu")
    before = dict(LAUNCHES)
    y = card.denoise_with_bits(x, bits)
    assert all(LAUNCHES[k] > before[k] for k in ("stft", "mask_gate",
                                                 "crm_istft", "bilstm"))
    torch.testing.assert_close(y.cpu(), host.denoise_with_bits(x, bits),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [*int8_gemm.SWEEP_SHAPES, (257, 144, 10)])
def test_int8_matmul_kernel_exact(cuda_device, m, k, n):
    """K5 at every shape of the sweep and a ragged one: through
    `int8_matmul` with a `(K, N)` B and a column-major (strided) A, and
    through `int8_matmul_nt` with B in the kernel's `(N, K)` layout."""
    gen = torch.Generator().manual_seed(m + n)
    a, b = _int8((m, k), gen, cuda_device), _int8((k, n), gen, cuda_device)
    ref = int8_gemm.int8_matmul_plain(a, b)
    strided = a.t().contiguous().t()
    assert not strided.is_contiguous()
    assert torch.equal(int8_gemm.int8_matmul(strided, b), ref)
    assert torch.equal(int8_gemm.int8_matmul_nt(a, b.t().contiguous()), ref)


def _trunk_geometries():
    """(Cin, Cout, kernel, dilation) of every trunk block after the first
    (the denoiser schedule holds the detector's), at 48 and 96 channels."""
    cfg = DenoiserModelConfig()
    return [(c, c, ks, dil) for c in (48, 96)
            for ks, dil in list(zip(cfg.kernel_sizes, cfg.dilations))[1:]]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cin,cout,ks,dil", _trunk_geometries())
def test_int8_conv_same_halo_kernel_exact(cuda_device, batch, cin, cout, ks,
                                          dil):
    """K6's Hopper tile at every trunk geometry; 80 rows, so that the
    32-row dilations both skip and keep tap rows; ragged batches."""
    assert int8_conv.halo_plan(178, cin, cout, ks, dil) is not None
    gen = torch.Generator().manual_seed(cin + 7 * dil[0] + dil[1] + ks[1])
    x = _int8((batch, 80, 178, cin), gen, cuda_device)
    w, w_s, b = _epilogue_params(cout, ks[0] * ks[1] * cin, gen, cuda_device)
    before = LAUNCHES["int8_conv"]
    got = int8_conv.conv_same_int8(x, w, w_s, b, ks, dil)
    assert LAUNCHES["int8_conv"] == before + 1
    assert torch.equal(got, int8_conv.conv_same_int8_plain(x, w, w_s, b, ks,
                                                           dil))


# K6's C entry point of each route (`int8_conv.conv_same_route`)
K6_ENTRIES = {"tile": "sos_int8_conv_same_halo",
              "first": "sos_int8_conv_first", "proj": "sos_int8_conv_proj",
              "gather": "sos_int8_conv_same"}


def _k6_entry_rose(entries, route):
    """Exactly one K6 entry point launched since `entries`: `route`'s."""
    rose = {name: ENTRY_LAUNCHES[name] - entries[name]
            for name in K6_ENTRIES.values()}
    assert rose == {name: int(name == K6_ENTRIES[route])
                    for name in K6_ENTRIES.values()}, rose


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,ks,dil,out_f32,hw,batch,route", [
    # the int8 main path's first layers and projections (enc_n's block 0
    # is the detector's shape; the detector's proj runs at 60 frames)
    (2, 48, (1, 7), (1, 1), False, (256, 178), 2, "first"),
    (2, 96, (1, 7), (1, 1), False, (256, 178), 2, "first"),
    (96, 8, (1, 1), (1, 1), True, (256, 178), 2, "proj"),
    (48, 4, (1, 1), (1, 1), True, (256, 178), 2, "proj"),
    (48, 8, (1, 1), (1, 1), True, (256, 60), 2, "proj"),
    # batch 1, an odd batch, and rows whose positions are no multiple of
    # a block's span (the last block ragged)
    (2, 96, (1, 7), (1, 1), False, (256, 178), 1, "first"),
    (2, 48, (1, 7), (1, 1), False, (30, 37), 3, "first"),
    (2, 96, (1, 7), (1, 1), False, (7, 5), 3, "first"),
    (96, 8, (1, 1), (1, 1), True, (256, 178), 1, "proj"),
    (48, 4, (1, 1), (1, 1), True, (30, 37), 3, "proj"),
    (96, 8, (1, 1), (1, 1), True, (7, 5), 3, "proj"),
    # the Hopper tile
    (48, 48, (5, 5), (32, 1), False, (256, 178), 2, "tile"),
    (96, 96, (5, 5), (32, 32), False, (64, 80), 2, "tile"),
    (96, 96, (5, 5), (32, 32), False, (256, 178), 2, "tile"),
    (16, 16, (5, 5), (2, 2), False, (30, 20), 2, "tile"),
    (32, 32, (7, 1), (1, 1), False, (40, 300), 2, "tile"),
    # the gather: narrow widths and a 1x1 with int8 output
    (6, 4, (7, 1), (1, 1), False, (30, 20), 2, "gather"),
    (2, 8, (1, 7), (1, 1), False, (30, 20), 2, "gather"),
    (8, 2, (1, 1), (1, 1), True, (30, 20), 2, "gather"),
    (48, 8, (1, 1), (1, 1), False, (30, 20), 2, "gather"),
])
def test_int8_conv_same_kernel_exact(cuda_device, cin, cout, ks, dil,
                                     out_f32, hw, batch, route):
    """Every K6 route, each on the kernel `conv_same_route` names for its
    shape: the first-layer kernel (Cin 2, 1x7) and the projection kernel
    (1x1, float32 out) at every shape of the int8 main path, the Hopper
    tile (Cin % 16 == 0, spatial kernels, here also narrow widths and a
    row of two segments) and the gather (every other shape), bit-equal
    to the plain version."""
    assert int8_conv.conv_same_route(hw[1], cin, cout, ks, dil,
                                     out_f32) == route
    gen = torch.Generator().manual_seed(cin * cout + batch + hw[1])
    x = _int8((batch, *hw, cin), gen, cuda_device)
    w, w_s, b = _epilogue_params(cout, ks[0] * ks[1] * cin, gen, cuda_device)
    entries = dict(ENTRY_LAUNCHES)
    got = int8_conv.conv_same_int8(x, w, w_s, b, ks, dil, out_f32)
    _k6_entry_rose(entries, route)
    ref = int8_conv.conv_same_int8_plain(x, w, w_s, b, ks, dil, out_f32)
    assert got.shape == ref.shape == (batch, *hw, cout)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,ks,dil,out_f32,route", [
    (96, 96, (5, 5), (32, 1), False, "tile"),
    (2, 48, (1, 7), (1, 1), False, "first"),
    (2, 96, (1, 7), (1, 1), False, "first"),
    (96, 8, (1, 1), (1, 1), True, "proj"),
    (48, 4, (1, 1), (1, 1), True, "proj"),
])
def test_int8_conv_same_kernel_takes_strided_views(cuda_device, cin, cout,
                                                   ks, dil, out_f32, route):
    """K6's kernels on an input that is a channel slice of a wider
    tensor and weights that are a column slice of a wider packing."""
    gen = torch.Generator().manual_seed(cin + cout)
    x = _int8((2, 64, 178, cin + 16), gen, cuda_device)[..., 16:]
    w, w_s, b = _epilogue_params(cout, ks[0] * ks[1] * cin, gen, cuda_device)
    wide = torch.zeros(cout, w.shape[1] + 64, dtype=torch.int8,
                       device=cuda_device)
    wide[:, 64:] = w
    w_view = wide[:, 64:]
    assert not x.is_contiguous() and not w_view.is_contiguous()
    entries = dict(ENTRY_LAUNCHES)
    got = int8_conv.conv_same_int8(x, w_view, w_s, b, ks, dil, out_f32)
    _k6_entry_rose(entries, route)
    assert torch.equal(got, int8_conv.conv_same_int8_plain(x, w, w_s, b, ks,
                                                           dil, out_f32))


def _row_widths(batch, width, pad, gen, device, widths="spread",
                edges=()):
    """Per-row valid widths. "spread": 1, the full width, one within
    `pad` of it, the rest spread over [2, width); "edges": `edges` (the
    widths about a segment's first column and a warpgroup's, each
    clipped to W + 1 at most), then 1, the full width and one past it,
    cycled over the batch; "full": every row at the full width; "one":
    every row at 1."""
    if widths == "spread":
        fixed = [1, width, max(1, width - max(pad, 1))]
        rest = torch.randint(2, width, (max(0, batch - 3),), generator=gen)
        vals = fixed[:batch] + rest.tolist()
    elif widths == "edges":
        cycle = [min(e, width + 1) for e in edges] + [1, width, width + 7]
        vals = [cycle[i % len(cycle)] for i in range(batch)]
    else:
        vals = [width if widths == "full" else 1] * batch
    return torch.tensor(vals, dtype=torch.int64).to(device)


# per-row widths of the valid_t card tests (`_row_widths`)
WIDTHS = ("spread", "edges", "full", "one")


@pytest.mark.cuda
@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("cin,cout,ks,dil,out_f32,hw,batch,route", [
    (96, 96, (5, 5), (32, 1), False, (256, 1024), 8, "tile"),  # enc_x 7
    (48, 48, (5, 5), (32, 32), False, (64, 512), 4, "tile"),
    (2, 96, (1, 7), (1, 1), False, (256, 1024), 8, "first"),   # enc_x 0
    (2, 48, (1, 7), (1, 1), False, (256, 178), 5, "first"),
    (2, 48, (1, 7), (1, 1), False, (30, 37), 3, "first"),
    (96, 8, (1, 1), (1, 1), True, (256, 1024), 5, "proj"),     # enc_x proj
    (48, 4, (1, 1), (1, 1), True, (256, 178), 5, "proj"),
    (48, 8, (1, 1), (1, 1), True, (256, 60), 3, "proj"),
    (16, 16, (5, 5), (2, 2), False, (30, 20), 4, "tile"),
    (2, 8, (1, 7), (1, 1), False, (30, 20), 4, "gather"),
])
def test_int8_conv_same_kernel_valid_t_exact(cuda_device, cin, cout, ks,
                                             dil, out_f32, hw, batch, route,
                                             widths):
    """K6 with per-row valid widths (`_row_widths`: spread; about the
    tile's segments and warpgroups, at 1, the full width and past it;
    all full; all 1), on every route, against the plain version exactly:
    zeros past each row's width (the input, garbage there too, is taken
    as it is); counted as the valid_t case."""
    gen = torch.Generator().manual_seed(cin + cout + hw[1])
    x = _int8((batch, *hw, cin), gen, cuda_device)
    w, w_s, b = _epilogue_params(cout, ks[0] * ks[1] * cin, gen, cuda_device)
    plan = int8_conv.halo_plan(hw[1], cin, cout, ks, dil)
    seg = int8_conv.HALO_SEG if plan is None else plan.seg_len
    vt = _row_widths(batch, hw[1], (ks[1] - 1) // 2 * dil[1], gen,
                     cuda_device, widths, (seg - 1, seg, seg + 1, seg + 64))
    before, entries = dict(LAUNCHES), dict(ENTRY_LAUNCHES)
    got = int8_conv.conv_same_int8(x, w, w_s, b, ks, dil, out_f32,
                                   valid_t=vt)
    assert LAUNCHES["int8_conv_valid_t"] == before["int8_conv_valid_t"] + 1
    assert LAUNCHES["int8_conv"] == before["int8_conv"]
    _k6_entry_rose(entries, route)
    ref = int8_conv.conv_same_int8_plain(x, w, w_s, b, ks, dil, out_f32,
                                         valid_t=vt)
    assert torch.equal(got, ref)
    for row, v in enumerate(vt.tolist()):
        assert not got[row, :, v:].any()


# every distinct full-width InpaintNet block at bucket 1,024 (InpaintNet
# widths 1,024 / 512 / 256): rows in segments; kind, k, stride,
# dilation, Cin, Cout, (H, W)
INPAINT_BUCKET = [
    ("down", 5, 1, 1, 2, 64, (256, 1024)),     # a_in, b_in
    ("down", 5, 2, 1, 64, 128, (256, 1024)),   # a_d1, b_d1
    ("down", 5, 1, 1, 128, 128, (128, 512)),   # a_d2, b_d2
    ("down", 3, 2, 1, 256, 256, (128, 512)),   # mid0
    *[("down", 3, 1, d, 256, 256, (64, 256)) for d in (1, 2, 4, 8, 16)],
    ("up", 3, 2, 1, 256, 128, (64, 256)),      # mid_up
    ("down", 3, 1, 1, 256, 128, (128, 512)),   # up1_conv
    ("up", 3, 2, 1, 128, 64, (128, 512)),      # up1_up
    ("down", 3, 1, 1, 128, 64, (256, 1024)),   # up2_conv
]


@pytest.mark.cuda
@pytest.mark.parametrize("widths", (None,) + WIDTHS)
@pytest.mark.parametrize("kind,k,s,d,cin,cout,hw", [
    *INPAINT_BUCKET,
    ("down", 3, 1, 16, 256, 256, (64, 45)),   # one segment, the patch warp
    ("up", 3, 2, 1, 6, 4, (9, 37)),           # gather: Cout 4
    ("down", 5, 2, 1, 2, 8, (30, 50)),        # gather: Cout 8
    ("down", 3, 1, 4, 32, 32, (16, 200)),     # pad within a segment's end
])
def test_inpaint_conv_kernel_valid_t_exact(cuda_device, widths, kind, k, s,
                                           d, cin, cout, hw):
    """K7 at every full-width InpaintNet block at bucket 1,024 (rows in
    segments on the Hopper tile), and on the gather for the Couts the
    tile has no width for: with per-row valid widths (`_row_widths`:
    spread; about the first output column of a segment and of a
    warpgroup, at 1, the full width and past it; all full; all 1;
    garbage past them) and without (None: the exact mode's long rows),
    against the plain version exactly. Neither route falls back: the
    tile's shapes never launch the gather."""
    gen = torch.Generator().manual_seed(cin + cout + d + hw[1])
    batch = 8 if hw[1] >= 256 else 4
    x = _int8((batch, *hw, cin), gen, cuda_device)
    w, w_s, b = _epilogue_params(cout, k * k * cin, gen, cuda_device)
    alpha = torch.tensor([0.2], device=cuda_device)
    plan = int8_conv.inpaint_plan(kind, k, s, d, *hw, cin, cout)
    assert (plan is None) == (cout % 16 != 0)
    valid = widths is not None
    vt = None
    if valid:
        edge = (int8_conv.INPAINT_M if plan is None
                else plan.seg_len * plan.os)
        vt = _row_widths(batch, hw[1], (k - 1) // 2 * d, gen, cuda_device,
                         widths, [_input_width(kind, k, s, d, hw[1], t)
                                  for t in (edge - 1, edge, edge + 1,
                                            edge + 64)])
    counter = "int8_inpaint_valid_t" if valid else "int8_inpaint"
    before, entries = dict(LAUNCHES), dict(ENTRY_LAUNCHES)
    got = int8_conv.inpaint_conv_int8(x, w, w_s, b, alpha, kind, k, s, d,
                                      valid_t=vt)
    assert LAUNCHES[counter] == before[counter] + 1
    gather = ENTRY_LAUNCHES["sos_int8_conv_inpaint"] \
        - entries["sos_int8_conv_inpaint"]
    assert gather == (plan is None)
    ref = int8_conv.inpaint_conv_int8_plain(x, w, w_s, b, alpha, kind, k, s,
                                            d, vt)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


def _input_width(kind, k, s, d, width, target):
    """The least input width whose output width reaches `target` (one
    past `width` where none does)."""
    return next((v for v in range(1, width + 1)
                 if int8_conv.inpaint_valid_out(kind, k, s, d, v) >= target),
                width + 1)


@pytest.mark.cuda
def test_valid_t_kernels_replay_in_a_cuda_graph(cuda_device):
    """K6's and K7's masked instances captured with per-row widths into a
    CUDA graph, replayed after new widths are written into the same
    tensor: each replay matches the plain version at the new widths. So
    the kernels read the widths on the card at run time, and neither
    wrapper syncs (a sync inside a capture raises)."""
    gen = torch.Generator().manual_seed(18)
    x6 = _int8((4, 64, 512, 96), gen, cuda_device)
    w6, ws6, b6 = _epilogue_params(96, 25 * 96, gen, cuda_device)
    x7 = _int8((4, 64, 512, 64), gen, cuda_device)
    w7, ws7, b7 = _epilogue_params(128, 25 * 64, gen, cuda_device)
    alpha = torch.tensor([0.2], device=cuda_device)
    vt = torch.tensor([512, 300, 191, 1], dtype=torch.int32,
                      device=cuda_device)

    def k6(fn=int8_conv.conv_same_int8):
        return fn(x6, w6, ws6, b6, (5, 5), (32, 1), valid_t=vt)

    def k7(fn=int8_conv.inpaint_conv_int8):
        return fn(x7, w7, ws7, b7, alpha, "down", 5, 2, 1, valid_t=vt)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds, plans, allocator pools
        k6(), k7()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    with torch.cuda.graph(graph):
        y6, y7 = k6(), k7()
    assert LAUNCHES["int8_conv_valid_t"] == before["int8_conv_valid_t"] + 1
    assert LAUNCHES["int8_inpaint_valid_t"] \
        == before["int8_inpaint_valid_t"] + 1
    for widths in ([512, 300, 191, 1], [1, 193, 512, 64], [0, 512, 600, 256]):
        vt.copy_(torch.tensor(widths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y6, k6(int8_conv.conv_same_int8_plain)), widths
        assert torch.equal(y7, k7(int8_conv.inpaint_conv_int8_plain)), widths


# every distinct full-width InpaintNet block (sos_tpu/models/quant.py SPEC
# at channels 64/128/256, F 256 x T 178): kind, k, stride, dilation, Cin,
# Cout, (H, W)
INPAINT_FULL = [
    ("down", 5, 1, 1, 2, 64, (256, 178)),      # a_in, b_in
    ("down", 5, 2, 1, 64, 128, (256, 178)),    # a_d1, b_d1
    ("down", 5, 1, 1, 128, 128, (128, 89)),    # a_d2, b_d2
    ("down", 3, 2, 1, 256, 256, (128, 89)),    # mid0
    *[("down", 3, 1, d, 256, 256, (64, 45)) for d in (1, 2, 4, 8, 16)],
    ("up", 3, 2, 1, 256, 128, (64, 45)),       # mid_up
    ("down", 3, 1, 1, 256, 128, (128, 89)),    # up1_conv
    ("up", 3, 2, 1, 128, 64, (128, 89)),       # up1_up
    ("down", 3, 1, 1, 128, 64, (256, 178)),    # up2_conv
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,kind,k,s,d,cin,cout,hw", [
    *[(bt, *g) for g in INPAINT_FULL for bt in (1, 3)],
    (2, "up", 3, 2, 1, 256, 128, (32, 23)),   # odd W
    (2, "up", 3, 2, 1, 128, 64, (33, 21)),    # odd H and W
    (2, "down", 3, 1, 4, 32, 32, (5, 5)),     # reflect pad = W - 1
    (2, "down", 3, 2, 2, 6, 32, (21, 14)),    # Cin 6 padded to 16
    (2, "up", 3, 2, 1, 6, 4, (9, 7)),         # gather: Cout 4
    (2, "down", 5, 2, 1, 2, 8, (30, 20)),     # gather: Cout 8
])
def test_inpaint_conv_kernel_exact(cuda_device, batch, kind, k, s, d, cin,
                                   cout, hw):
    """K7 on the Hopper tile at every full-width InpaintNet block, and on
    the gather for the Couts the tile has no width for."""
    gen = torch.Generator().manual_seed(cin + cout + d + batch)
    x = _int8((batch, *hw, cin), gen, cuda_device)
    w, w_s, b = _epilogue_params(cout, k * k * cin, gen, cuda_device)
    alpha = torch.tensor([0.2], device=cuda_device)
    assert (int8_conv.inpaint_plan(kind, k, s, d, *hw, cin, cout) is None) \
        == (cout % 16 != 0)
    before = LAUNCHES["int8_inpaint"]
    got = int8_conv.inpaint_conv_int8(x, w, w_s, b, alpha, kind, k, s, d)
    assert LAUNCHES["int8_inpaint"] == before + 1
    ref = int8_conv.inpaint_conv_int8_plain(x, w, w_s, b, alpha, kind, k, s, d)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,s,d,cin,cout,hw", [
    ("down", 3, 1, 16, 256, 256, (64, 45)),
    ("down", 5, 2, 1, 64, 128, (64, 178)),
    ("up", 3, 2, 1, 256, 128, (64, 45)),
    ("down", 5, 1, 1, 2, 64, (64, 178)),
])
def test_inpaint_conv_kernel_takes_strided_views(cuda_device, kind, k, s, d,
                                                 cin, cout, hw):
    """K7 on an input that is a channel slice of a wider tensor and weights
    that are a column slice of a wider packing."""
    gen = torch.Generator().manual_seed(cin + cout + d)
    x = _int8((2, *hw, cin + 16), gen, cuda_device)[..., 16:]
    w, w_s, b = _epilogue_params(cout, k * k * cin, gen, cuda_device)
    wide = torch.zeros(cout, w.shape[1] + 64, dtype=torch.int8,
                       device=cuda_device)
    wide[:, 64:] = w
    w_view = wide[:, 64:]
    alpha = torch.tensor([0.2], device=cuda_device)
    assert not x.is_contiguous() and not w_view.is_contiguous()
    assert torch.equal(
        int8_conv.inpaint_conv_int8(x, w_view, w_s, b, alpha, kind, k, s, d),
        int8_conv.inpaint_conv_int8_plain(x, w, w_s, b, alpha, kind, k, s, d))


@pytest.mark.cuda
def test_small_int8_pipeline_card_matches_cpu(cuda_device):
    """The int8 profile at small widths: card (K1-K7) against the CPU
    (plain versions) with the same scales."""
    ks, dils = ((1, 7), (5, 5)), ((1, 1), (2, 2))
    cfg = ExperimentConfig(
        detector=DetectorModelConfig(nf=16, outf=2, kernel_sizes=ks,
                                     dilations=dils, lstm_hidden=4,
                                     fc_hidden=4),
        denoiser=DenoiserModelConfig(nf_mixed=32, nf_noise=16, outf_mixed=8,
                                     outf_noise=4, kernel_sizes=ks,
                                     dilations=dils, lstm_hidden=8,
                                     fc_hidden=16, inpaint_ch=(16, 32, 64)),
        data=DataConfig())
    gen = torch.Generator().manual_seed(0)
    det = init_state_dict(SilenceDetector(cfg.detector), gen)
    den = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    x = torch.randn(2, 28000, generator=gen) * 0.2
    bits = (torch.rand(2, 60, generator=gen) < 0.5).float()
    host = FusedDenoisePipeline(cfg, det, den, profile="int8", device="cpu")
    host.detect_bits(x)  # calibrates
    card = FusedDenoisePipeline(cfg, det, den, profile="int8",
                                device=cuda_device)
    card._quant.load_calibration(host._quant.calibration_state())
    card._quant_det.load_calibration(host._quant_det.calibration_state())
    before = dict(LAUNCHES)
    y = card.denoise_with_bits(x, bits)
    assert all(LAUNCHES[k] > before[k] for k in (
        "stft", "mask_gate", "crm_istft", "bilstm", "int8_conv",
        "int8_inpaint"))
    torch.testing.assert_close(y.cpu(), host.denoise_with_bits(x, bits),
                               atol=1e-3, rtol=0)


def _launch_sites():
    """Every `launch(...)` call of the port -> (module, whether it lies in
    a `with on_device(...)` block)."""
    import ast
    root = kbuild.CSRC.parent
    found = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and getattr(it.context_expr.func, "id", None) == "on_device"
                    for it in node.items):
                guarded.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "launch"):
                found.append((path.relative_to(root).as_posix(),
                              id(node) in guarded))
    return found


def test_every_launch_is_made_on_the_device_of_its_input():
    """Each C entry point is called only inside `on_device(...)`, which
    makes the card of the wrapper's input current, so the launch, its
    kernels' shared-memory attributes and the occupancy queries act on
    the card that holds the tensors, whatever device the calling thread
    has current; and no launch helper keeps its shared-memory grant in
    one per-process scalar (a second card would launch with the first
    card's grant)."""
    sites = _launch_sites()
    assert {m for m, _ in sites} == {
        "dsp/mixing.py", "dsp/stft.py", "ops/int8_conv.py",
        "ops/int8_gemm.py", "ops/lstm.py"}
    assert all(ok for _, ok in sites), sites
    text = "\n".join(p.read_text() for p in kbuild.CSRC.glob("*.cu*"))
    assert not re.findall(r"static\s+(?:int|bool)\s+\w+\s*=", text)
    # the per-device grants: K5's, and K4's and K4b's shared `grant`
    # (csrc/cluster_exchange.cuh)
    assert len(re.findall(r"\[sosdev::kMaxDevices\]", text)) == 2


@pytest.mark.cuda
def test_kernels_run_on_the_device_of_their_inputs(cuda_device):
    """Two cards: K1's wrapper on tensors of card 1 while card 0 is
    current (the result lies on card 1 and card 0 stays current after
    it), and K4, K4's training instance, K4b and K5 on
    card 0 then card 1 (each card its own shared-memory grant), each
    against its plain version. A host with one card cannot show this;
    it runs where two cards are."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(3, 28000, generator=gen)
    ref = stft.stft_cat_plain(y)
    with torch.cuda.device(d0):
        before = kbuild.LAUNCHES["stft"]
        out = stft.stft_cat(y.to(d1))
        assert kbuild.LAUNCHES["stft"] == before + 1
        assert out.device == d1 and torch.cuda.current_device() == 0
    torch.cuda.synchronize(d1)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)
    for dev in (d0, d1):
        xp_f, xp_b, w_f, w_b = _recurrence_inputs(dev, 40, 178, 200, 7)
        torch.testing.assert_close(
            lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b),
            lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b),
            atol=5e-5, rtol=0)
        h, c, gates = lstm.bilstm_recurrence_train(xp_f, xp_b, w_f, w_b)
        dout = torch.randn_like(h)
        torch.testing.assert_close(
            lstm.bilstm_recurrence_backward(dout, gates, c, w_f, w_b),
            lstm.bilstm_recurrence_backward_plain(dout, gates, c, w_f, w_b),
            atol=1e-4, rtol=1e-4)
        a, b = _int8((4096, 1280), gen, dev), _int8((1280, 128), gen, dev)
        assert torch.equal(int8_gemm.int8_matmul(a, b),
                           int8_gemm.int8_matmul_plain(a, b))
