"""The port's dataset preprocessing (`data/preprocess.py`,
`python -m sos_tpu_torch preprocess`) against `sos_tpu`'s on the same
WAVs: 14 kHz and 44.1 kHz clips, one shorter than a video frame; the
bitstreams, records and the CLI's JSON must be equal (the same numpy
host code)."""

import json
import sys

import numpy as np
import pytest

from sos_tpu.cli import preprocess as jax_cli
from sos_tpu.data import preprocess as jax_pre
from sos_tpu_torch import __main__ as dispatcher
from sos_tpu_torch.data import preprocess as pre
from sos_tpu_torch.data.index import DatasetIndex
from sos_tpu_torch.dsp import audio_io

# (name, sample rate, seconds)
WAVS = (("a_speech14k", 14000, 2.3), ("b_speech44k", 44100, 1.7),
        ("c_short", 14000, 0.02))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    (root / "wavs" / "sub").mkdir(parents=True)
    rng = np.random.default_rng(5)
    paths = []
    for i, (name, sr, seconds) in enumerate(WAVS):
        n = int(sr * seconds)
        t = np.arange(n) / sr
        y = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
        y = (y + rng.standard_normal(n) * 0.01).astype(np.float32)
        path = root / "wavs" / ("sub" if i else "") / f"{name}.wav"
        audio_io.write_wav(str(path), y, sr)
        paths.append(str(path))
    return root, paths


@pytest.mark.parametrize("pad", [0.0, 0.5])
def test_label_bitstream_matches_sos_tpu(pad):
    rng = np.random.default_rng(11)
    y = rng.standard_normal(44100 * 3) * np.repeat(rng.random(30) < 0.5,
                                                   4410)
    got = pre.label_bitstream(y, 44100, pad_seconds=pad)
    assert got == jax_pre.label_bitstream(y, 44100, pad_seconds=pad)
    assert set(got) == ({"0", "1", "2"} if pad else {"0", "1"})
    assert pre.label_bitstream(y[:100], 44100) == ""


@pytest.mark.parametrize("kw", [{}, {"label_silence": True},
                                {"label_silence": True,
                                 "label_pad_seconds": 0.5}])
def test_process_audio_file_matches_sos_tpu(corpus, kw):
    for path in corpus[1]:
        got = pre.process_audio_file(path, **kw).to_json()
        assert got == jax_pre.process_audio_file(path, **kw).to_json()
        assert got["audio_sample_rate"] == 44100
    short = pre.process_audio_file(corpus[1][2], **kw)
    assert short.num_frames == 1 and len(short.bit_stream) == 1


def _cli(main, argv):
    saved = sys.argv
    sys.argv = ["preprocess"] + argv
    try:
        main()
    finally:
        sys.argv = saved


def test_cli_json_matches_sos_tpu(corpus, capsys):
    root, _ = corpus
    argv = ["--audio_dir", str(root / "wavs"), "--label_silence",
            "--label_pad_seconds", "0.5"]
    _cli(jax_cli.main, argv + ["--output_json", str(root / "jax.json")])
    assert dispatcher.main(["preprocess"] + argv + [
        "--output_json", str(root / "out" / "port.json")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"wrote {root / 'out' / 'port.json'}: 3 files"
    got = json.loads((root / "out" / "port.json").read_text())
    assert got == json.loads((root / "jax.json").read_text())
    index = DatasetIndex.load(str(root / "out" / "port.json"))
    assert [f.bit_stream for f in index.files] == [
        f["bit_stream"] for f in got["files"]]
    assert "2" in index.files[0].bit_stream and "0" in index.files[0].bit_stream
