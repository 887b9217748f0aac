"""The port's serving layer on the CPU: `sos_tpu_torch.cli.serve`
(`ServeLoop` and the stdin server), `sos_tpu_torch.cli.denoise`, the
`.pth` loader `models/torch_import.py` and the WAV I/O copy
`dsp/audio_io.py`, each against `sos_tpu`'s counterpart.

Tolerances: the CLIs' WAVs within 1 PCM LSB of `sos_tpu`'s on the same
`.pth` files (16-bit PCM truncates, so a float difference of 1e-6 can
move a sample one step); imported state_dicts and WAV bytes exact.
"""

import io
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sos_tpu.dsp import audio_io as jax_audio_io
from sos_tpu.models.torch_import import (denoiser_torch_to_flax,
                                         detector_torch_to_flax)
from sos_tpu_torch.cli.serve import ServeLoop
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.models.convert import denoiser_from_jax, detector_from_jax
from sos_tpu_torch.models.torch_import import (import_denoiser_checkpoint,
                                               import_detector_checkpoint)

from tests.torch_oracles import DetectorOracle, JointOracle, randomize_bn_stats
from tests.torch_port_fixtures import SPECS, tiny_configs

REPO = Path(__file__).resolve().parent.parent
SR = 14000


# -- ServeLoop (pure Python; sos_tpu's serve-loop cases) ----------------------


def _lines(*requests):
    return iter(list(requests) + ["QUIT"])


def test_serve_loop_overlaps_io_with_compute():
    """Decode of request N+1 and write of N-1 overlap the compute of N:
    k queued requests take well under the serial sum of the stages."""
    D, k = 0.05, 4
    emitted = []

    def load(path):
        time.sleep(D)
        return np.zeros(1400, np.float32), SR

    def denoise(wav):
        time.sleep(D)
        return wav

    def write(path, wav, sr):
        time.sleep(D)

    loop = ServeLoop(denoise, load, write, SR, emit=emitted.append)
    t0 = time.perf_counter()
    loop.run(_lines(*[f"in{i}.wav\tout{i}.wav" for i in range(k)]))
    wall = time.perf_counter() - t0
    oks = [ln.split()[1] for ln in emitted if ln.startswith("OK ")]
    assert oks == [f"out{i}.wav" for i in range(k)]
    assert emitted[-1] == "BYE"
    assert wall < 3 * D * k * 0.75, wall


def test_serve_loop_async_dispatch_overlaps_fetch():
    """With denoise_many_async the compute stage only dispatches: batch
    N+1 goes out while the writer still waits for batch N, and the
    responses keep request order."""
    D = 0.1
    emitted, log, lock = [], [], threading.Lock()

    def dma(wavs):
        with lock:
            log.append(("dispatch", time.perf_counter()))

        def fin():
            time.sleep(D)
            with lock:
                log.append(("finalized", time.perf_counter()))
            return list(wavs)

        return fin

    loop = ServeLoop(denoise=lambda w: w,
                     load=lambda p: (np.full(1400, float(p[2]), np.float32),
                                     SR),
                     write=lambda *a: None, sample_rate=SR,
                     emit=emitted.append, depth=2, denoise_many_async=dma)
    loop.run(_lines(*[f"in{i}.wav\tout{i}.wav" for i in range(8)]))
    oks = [ln.split()[1] for ln in emitted if ln.startswith("OK ")]
    assert oks == [f"out{i}.wav" for i in range(8)]
    assert emitted[-1] == "BYE"
    dispatches = [t for kind, t in log if kind == "dispatch"]
    finalized = [t for kind, t in log if kind == "finalized"]
    assert len(dispatches) >= 2 and dispatches[1] < finalized[0]


def _finalize_fails(wavs):
    def fin():
        raise RuntimeError("device fell over")

    return fin


def _dispatch_fails(wavs):
    raise RuntimeError("dispatch exploded")


@pytest.mark.parametrize("dma", [_finalize_fails, _dispatch_fails],
                         ids=["finalize fails", "dispatch fails"])
def test_serve_loop_async_failure_isolates_requests(dma):
    """A failing pipelined batch (at fetch or at dispatch) falls back to
    per-request denoise: one poisoned request gives one ERR, the others
    drained with it still succeed, all in arrival order."""
    emitted = []

    def denoise(wav):
        if wav[0] > 1.5:  # the poisoned request
            raise ValueError("bad audio")
        return wav

    loop = ServeLoop(denoise=denoise,
                     load=lambda p: (np.full(1400, float(p[2]), np.float32),
                                     SR),
                     write=lambda *a: None, sample_rate=SR,
                     emit=emitted.append, depth=4, denoise_many_async=dma)
    loop.run(_lines("in0.wav\tout0.wav", "in2.wav\tout2.wav",
                    "in1.wav\tout1.wav"))
    lines = [ln for ln in emitted if ln.startswith(("OK ", "ERR "))]
    assert len(lines) == 3
    assert lines[0].startswith("OK out0.wav")
    assert lines[1].startswith("ERR") and "bad audio" in lines[1]
    assert lines[2].startswith("OK out1.wav")
    assert loop.n_ok == 2 and loop.n_err == 1


def test_serve_loop_sigterm_while_decoding():
    """request_shutdown (SIGTERM) == QUIT: requests already received are
    answered, even one whose decode outlasts the drain's poll window."""
    emitted = []
    lines_q = queue.Queue()

    def lines():
        while True:
            item = lines_q.get()
            if item is None:
                return
            yield item

    in_load_b = threading.Event()

    def load(path):
        if path == "b.wav":
            in_load_b.set()
            time.sleep(0.7)  # slower than the drain's 0.2 s poll
        return np.zeros(1400, np.float32), SR

    loop = ServeLoop(lambda wav: wav, load, lambda *a: None, SR,
                     emit=emitted.append)
    t = threading.Thread(target=loop.run, args=(lines(),), daemon=True)
    t.start()
    lines_q.put("a.wav\tout_a.wav")
    lines_q.put("b.wav\tout_b.wav")
    assert in_load_b.wait(timeout=10)
    loop.request_shutdown()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [ln.split()[1] for ln in emitted if ln.startswith("OK ")] \
        == ["out_a.wav", "out_b.wav"]
    assert emitted[-1] == "BYE"


def test_serve_loop_shutdown_before_run():
    """SIGTERM before run() (during --warmup) is not lost: BYE at once."""
    emitted = []
    loop = ServeLoop(lambda w: w, lambda p: (np.zeros(4, np.float32), SR),
                     lambda *a: None, SR, emit=emitted.append)
    loop.request_shutdown()

    def never_yields():
        while True:
            time.sleep(0.05)
            yield  # pragma: no cover

    t = threading.Thread(target=loop.run, args=(never_yields(),),
                         daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert emitted == ["BYE"]


def test_serve_loop_sigterm_answers_line_already_read():
    """A line the reader has already pulled when SIGTERM lands is still
    answered."""
    emitted = []
    loop = ServeLoop(lambda wav: wav,
                     lambda p: (np.zeros(1400, np.float32), SR),
                     lambda *a: None, SR, emit=emitted.append)

    def lines():
        yield "a.wav\tout_a.wav"
        loop.request_shutdown()  # lands with line b on its way
        yield "b.wav\tout_b.wav"

    t = threading.Thread(target=loop.run, args=(lines(),), daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [ln.split()[1] for ln in emitted if ln.startswith("OK ")] \
        == ["out_a.wav", "out_b.wav"]
    assert emitted[-1] == "BYE"


def test_serve_loop_protocol_lines():
    """PING answers at once, STATS counts, a bad line and a failed load
    give ERR in place."""
    emitted = []

    def load(path):
        if path == "missing.wav":
            raise FileNotFoundError(path)
        return np.zeros(SR, np.float32), SR

    loop = ServeLoop(lambda w: w, load, lambda *a: None, SR,
                     emit=emitted.append)
    loop.run(iter(["PING", "a.wav\tout_a.wav", "no tab here",
                   "missing.wav\tx.wav", "QUIT"]))
    assert emitted[0] == "PONG"
    rest = [ln.split()[0] for ln in emitted[1:]]
    assert rest == ["OK", "ERR", "ERR", "BYE"]
    assert loop.n_ok == 1 and loop.n_err == 2 and loop.audio_s == 1.0


# -- checkpoints ------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Reference-layout `.pth` files of seeded oracles at the tiny widths
    (the detector head sharpened, so that random weights give mixed bits),
    and the tiny config as JSON."""
    cfg, _ = tiny_configs()
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(100)
    d, n = cfg.detector, cfg.denoiser
    det = DetectorOracle(SPECS, freq_bins=d.freq_bins, nf=d.nf, outf=d.outf,
                         hidden=d.lstm_hidden, fc_hidden=d.fc_hidden)
    den = JointOracle(SPECS, freq_bins=n.freq_bins, ch=n.inpaint_ch,
                      nf=n.nf_mixed, hidden=n.lstm_hidden,
                      fc_hidden=n.fc_hidden)
    with torch.no_grad():
        randomize_bn_stats(det, gen)
        randomize_bn_stats(den, gen)
        det.fc1[2].weight.mul_(40)
        det.fc1[2].bias.mul_(40)
    root = tmp_path_factory.mktemp("serve")
    paths = {"det": str(root / "ckpt_epoch87.pth"),
             "den": str(root / "ckpt_epoch24.pth"),
             "cfg": str(root / "tiny_config.json"), "root": root}
    # the detector as DataParallel saves it: every key under `module.`
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                     det.state_dict().items()}}, paths["det"])
    torch.save({"model_state_dict": den.state_dict(), "clock": {}},
               paths["den"])
    Path(paths["cfg"]).write_text(cfg.to_json())
    paths["states"] = {"det": det.state_dict(), "den": den.state_dict()}
    return paths


def _numpy_state(state, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in state.items()}


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("stage", ["det", "den"])
def test_import_checkpoint_matches_sos_tpu(checkpoints, tmp_path, stage,
                                           prefix):
    state = {k: v for k, v in checkpoints["states"][stage].items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": {prefix + k: v for k, v in state.items()}},
               path)
    port = (import_detector_checkpoint if stage == "det"
            else import_denoiser_checkpoint)(path)
    to_flax, from_jax = ((detector_torch_to_flax, detector_from_jax)
                         if stage == "det" else
                         (denoiser_torch_to_flax, denoiser_from_jax))
    ref = from_jax(to_flax(_numpy_state(state, prefix)))
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == ref[key].dtype == torch.float32
        assert torch.equal(port[key], ref[key]), key


# -- the CLIs ----------------------------------------------------------------------


def _utterance(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    bursts = np.sin(2 * np.pi * 220.0 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    return (0.4 * bursts + rng.standard_normal(n) * 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def clips(checkpoints):
    """A 5 s and a 1.5 s utterance as 16-bit WAVs."""
    d = checkpoints["root"] / "clips"
    d.mkdir()
    for name, n in (("c0.wav", 70000), ("c1.wav", 21000)):
        audio_io.write_wav(str(d / name), _utterance(n, seed=n), SR)
    return d


def _pcm(path) -> np.ndarray:
    return np.round(audio_io.read_wav(str(path))[0] * 32768).astype(np.int32)


def _assert_within_one_lsb(got, ref):
    a, b = _pcm(got), _pcm(ref)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1


def _model_args(checkpoints, out_root):
    return ["--detector_pth", checkpoints["det"],
            "--denoiser_pth", checkpoints["den"],
            "--config_json", checkpoints["cfg"], "--name", "tiny",
            "--output_root", str(out_root)]


def _run_sos_tpu_serve(monkeypatch, capsys, argv, lines):
    """`sos_tpu.cli.serve` in this process (JAX on the CPU), its stdin
    given; returns its stdout lines."""
    from sos_tpu.cli import serve as jax_serve

    monkeypatch.setattr(signal, "signal", lambda *a: None)  # keep pytest's
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(
        ln + "\n" for ln in lines)))
    jax_serve.main()
    return capsys.readouterr().out.splitlines()


def test_serve_subprocess_protocol_matches_sos_tpu(checkpoints, clips,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    """`python -m sos_tpu_torch.cli.serve --device cpu`: READY, PONG, two
    OKs, one ERR, STATS, BYE; its WAVs within 1 LSB of sos_tpu's serve."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sos_tpu_torch.cli.serve", "--device", "cpu",
         *_model_args(checkpoints, tmp_path / "port_out")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))

    def say(line):
        proc.stdin.write(line + "\n")
        proc.stdin.flush()

    def hear():
        return proc.stdout.readline().strip()

    outs = [str(tmp_path / "port0.wav"), str(tmp_path / "port1.wav")]
    try:
        assert hear() == "READY"
        say("PING")
        assert hear() == "PONG"
        say(f"{clips / 'c0.wav'}\t{outs[0]}")
        say(f"{clips / 'c1.wav'}\t{outs[1]}")
        say(f"{tmp_path / 'missing.wav'}\t{tmp_path / 'x.wav'}")
        assert hear().startswith("OK " + outs[0])
        assert hear().startswith("OK " + outs[1])
        assert hear().startswith("ERR FileNotFoundError")
        say("STATS")
        stats = hear()
        assert stats.startswith("STATS ok=2 err=1 audio_s=6.50"), stats
        say("QUIT")
        assert hear() == "BYE"
    finally:
        proc.stdin.close()
        proc.wait(timeout=120)
    assert proc.returncode == 0

    refs = [str(tmp_path / "ref0.wav"), str(tmp_path / "ref1.wav")]
    said = _run_sos_tpu_serve(
        monkeypatch, capsys, _model_args(checkpoints, tmp_path / "ref_out"),
        [f"{clips / 'c0.wav'}\t{refs[0]}", f"{clips / 'c1.wav'}\t{refs[1]}",
         "QUIT"])
    assert said[0] == "READY" and said[-1] == "BYE"
    for got, ref in zip(outs, refs):
        _assert_within_one_lsb(got, ref)


def test_serve_without_a_card_raises(checkpoints, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from sos_tpu_torch.cli import serve

    monkeypatch.setattr(sys, "argv", ["serve", *_model_args(
        checkpoints, tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()


@pytest.mark.parametrize("argv", [["--detector_ckpt", "latest"], []],
                         ids=["orbax name", "no checkpoint"])
def test_cli_refuses_the_orbax_route(tmp_path, monkeypatch, capsys, argv):
    """`--detector_ckpt` (default `latest`) reads the port's own
    `<model dir>/latest.pt`. `sos_tpu`'s orbax checkpoint there (a
    directory) stays a usage error that says why (JAX); with no
    checkpoint at all the error names the file it looked for."""
    from sos_tpu_torch.cli import denoise

    model_dir = tmp_path / "experiment_detector" / "model"
    if argv:
        (model_dir / "latest").mkdir(parents=True)
    monkeypatch.setattr(sys, "argv", ["denoise", "--input", "a.wav",
                                      "--output", "b.wav", "--device", "cpu",
                                      "--output_root", str(tmp_path), *argv])
    with pytest.raises(SystemExit) as exit_info:
        denoise.main()
    assert exit_info.value.code == 2
    err = " ".join(capsys.readouterr().err.split())
    assert "--detector_pth" in err
    if argv:
        assert str(model_dir / "latest") in err
        assert "orbax" in err and "JAX" in err
    else:
        assert str(model_dir / "latest.pt") in err


@pytest.fixture(autouse=True)
def _compile_cache_in_tmp(tmp_path, monkeypatch):
    """sos_tpu's CLIs keep an XLA compile cache; keep it in the test's
    directory."""
    monkeypatch.setenv("SOS_TPU_COMPILE_CACHE", str(tmp_path / "xla_cache"))


def _run_main(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["denoise"] + argv)
    main()


def test_denoise_cli_matches_sos_tpu(checkpoints, clips, tmp_path,
                                     monkeypatch):
    """`cli.denoise`: single file, then --input_dir (one group, and a
    group per file), each within 1 LSB of sos_tpu's denoise CLI; the
    batch mode equal to the single-file mode."""
    from sos_tpu.cli import denoise as jax_denoise
    from sos_tpu_torch.cli import denoise

    common = _model_args(checkpoints, tmp_path / "out")
    port_one, ref_one = tmp_path / "port_c0.wav", tmp_path / "ref_c0.wav"
    _run_main(denoise.main, ["--input", str(clips / "c0.wav"), "--output",
                             str(port_one), "--device", "cpu"] + common,
              monkeypatch)
    _run_main(jax_denoise.main, ["--input", str(clips / "c0.wav"),
                                 "--output", str(ref_one)] + common,
              monkeypatch)
    _assert_within_one_lsb(port_one, ref_one)

    dirs = {}
    for who, main, extra in (("port", denoise.main, ["--device", "cpu"]),
                             ("ref", jax_denoise.main, [])):
        dirs[who] = tmp_path / f"{who}_batch"
        _run_main(main, ["--input_dir", str(clips), "--output_dir",
                         str(dirs[who])] + extra + common, monkeypatch)
    assert sorted(os.listdir(dirs["port"])) == ["c0.wav", "c1.wav"]
    for name in ("c0.wav", "c1.wav"):
        _assert_within_one_lsb(dirs["port"] / name, dirs["ref"] / name)
    np.testing.assert_array_equal(_pcm(dirs["port"] / "c0.wav"),
                                  _pcm(port_one))

    # a group per file: the multi-chunk file is unchanged; the 1.5 s
    # file, alone in its group, takes the fused call instead of the
    # two-pass route it takes beside a longer file (within 1e-5)
    monkeypatch.setattr(denoise, "GROUP_CHUNK_BATCHES", 0)
    split = tmp_path / "port_split"
    _run_main(denoise.main, ["--input_dir", str(clips), "--output_dir",
                             str(split), "--device", "cpu"] + common,
              monkeypatch)
    np.testing.assert_array_equal(_pcm(split / "c0.wav"),
                                  _pcm(dirs["port"] / "c0.wav"))
    _assert_within_one_lsb(split / "c1.wav", dirs["port"] / "c1.wav")

    with pytest.raises(SystemExit):  # --input_dir needs --output_dir
        _run_main(denoise.main, ["--input_dir", str(clips), "--device",
                                 "cpu"] + common, monkeypatch)


# -- audio_io ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3000,), (2000, 2)], ids=["mono", "stereo"])
def test_write_wav_byte_identical(tmp_path, shape):
    y = np.random.default_rng(1).uniform(-1.3, 1.3, shape).astype(np.float32)
    a, b = tmp_path / "port.wav", tmp_path / "ref.wav"
    audio_io.write_wav(str(a), y, 16000)
    jax_audio_io.write_wav(str(b), y, 16000)
    assert a.read_bytes() == b.read_bytes()


def _riff(path, samples: bytes, fmt_tag: int, channels: int, sr: int,
          bits: int):
    block = channels * bits // 8
    fmt = (fmt_tag.to_bytes(2, "little") + channels.to_bytes(2, "little")
           + sr.to_bytes(4, "little") + (sr * block).to_bytes(4, "little")
           + block.to_bytes(2, "little") + bits.to_bytes(2, "little"))
    body = (b"WAVE" + b"fmt " + len(fmt).to_bytes(4, "little") + fmt
            + b"data" + len(samples).to_bytes(4, "little") + samples)
    Path(path).write_bytes(b"RIFF" + len(body).to_bytes(4, "little") + body)


def _pcm24(x):
    v = (np.clip(x, -1, 1) * 8388607).astype(np.int32)
    return np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.uint8)


WAV_KINDS = {
    "pcm8": (1, 8, lambda x: (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8)),
    "pcm24": (1, 24, _pcm24),
    "pcm32": (1, 32, lambda x: (np.clip(x, -1, 1) * 2147483000).astype("<i4")),
    "float32": (3, 32, lambda x: x.astype("<f4")),
    "float64": (3, 64, lambda x: x.astype("<f8")),
}


@pytest.mark.parametrize("kind", WAV_KINDS)
@pytest.mark.parametrize("sr", [16000, 14000])
def test_load_and_resample_identical(tmp_path, kind, sr):
    tag, bits, encode = WAV_KINDS[kind]
    x = np.random.default_rng(2).uniform(-1, 1, (4000, 2))
    path = str(tmp_path / f"{kind}.wav")
    _riff(path, encode(x).tobytes(), tag, 2, sr, bits)
    for kw in (dict(sr=SR), dict(sr=None), dict(sr=8000, offset=0.01,
                                                 duration=0.1)):
        got, got_sr = audio_io.load(path, **kw)
        ref, ref_sr = jax_audio_io.load(path, **kw)
        assert got_sr == ref_sr and got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert audio_io.duration_seconds(path) == \
        jax_audio_io.duration_seconds(path) == 4000 / sr
    y = np.random.default_rng(3).standard_normal(1234).astype(np.float32)
    np.testing.assert_array_equal(audio_io.resample(y, sr, 11025),
                                  jax_audio_io.resample(y, sr, 11025))
