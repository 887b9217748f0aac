"""K2's long windows and generic despeckle, against `sos_tpu`, on the CPU.

`bitstream_to_sample_mask`, `mask_gate_plain` and K2's host table are
held exactly against `sos_tpu/dsp/mixing.py` `bitstream_to_sample_mask`
at windows past the dense matrices' 2^24 elements (6.4 s, 8 s, 60 s and
600 s at 14 kHz / 30 fps), and in the generic-despeckle geometry
(`despeckle_min_run` 600, above the ~466-sample frame body) and with
`min_run` 1. The kernel needs a card (chip_smoke.py phase 3); here its
table is evaluated with the kernel's own formulas in numpy: the words'
int16 halves, each chunk's staged frames, and the despeckle instance's
runs clipped to each block's window.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.dsp import mixing as jmix
from sos_tpu_torch.dsp import mixing as tmix

SR, FPS = 14000, 30
RATIO = SR / FPS
CPU = torch.device("cpu")
# (frames, samples) of each window: int(t * 30) bits, t * 14000 samples
WINDOWS = {"6.4s": (192, 89600), "8s": (240, 112000),
           "60s": (1800, 840000), "600s": (18000, 8400000)}


def _bits(pattern: str, frames: int, rows: int = 2) -> np.ndarray:
    if pattern == "silent":
        return np.zeros((1, frames), np.float32)
    if pattern == "speech":
        return np.ones((1, frames), np.float32)
    rng = np.random.default_rng(frames)
    return (rng.random((rows, frames)) < 0.5).astype(np.float32)


def _sos_tpu_mask(bits, samples, min_run=5) -> np.ndarray:
    return np.asarray(jmix.bitstream_to_sample_mask(
        jnp.asarray(bits), RATIO, samples, min_run))


def _kernel_gate_mask(tables: tmix.GateTables, bits: np.ndarray,
                      frames: int) -> np.ndarray:
    """The gate instance's mask from its table, as the kernel reads it:
    each chunk's (first, end) covers every frame its words read, a span
    of 1,024 samples stages at most `span_frames`, and a word is
    `inv[f] (+ inv[g] * inv[g + 1])` with frames relative to `first`."""
    words, spans = tables.words.numpy(), tables.spans.numpy()
    body, pair = (words << 16) >> 16, words >> 16
    idx = np.arange(len(words))
    first, end = spans[idx // 256, 0], spans[idx // 256, 1]
    for used in (body, pair, np.where((pair >= 0) & (pair < frames - 1),
                                      pair + 1, -1)):
        on = used >= 0
        assert np.all(used[on] >= first[on]) and np.all(used[on] < end[on])
    per_span = spans.reshape(-1, 2) if len(spans) % 4 else spans.reshape(-1, 4, 2)
    if per_span.ndim == 3:
        width = per_span[:, :, 1].max(1) - per_span[:, :, 0].min(1)
        assert width.max() <= tables.span_frames
    inv = 1.0 - bits
    pair_val = np.concatenate([inv[:, :-1] * inv[:, 1:], inv[:, -1:]], axis=1)
    return (np.where(body >= 0, inv[:, np.maximum(body, 0)], 0.0)
            + np.where(pair >= 0, pair_val[:, np.maximum(pair, 0)], 0.0)
            ).astype(np.float32)


def _kernel_despeckle_mask(tables: tmix.GateTables, bits: np.ndarray,
                           min_run: int) -> np.ndarray:
    """The despeckle instance's mask: m0 from the body halves, then each
    sample's run clipped to its block's window (the span of 1,024 plus
    min_run - 1 on each side); a clipped length under min_run flips."""
    words = tables.words.numpy()
    body = (words << 16) >> 16
    length = len(words)
    m0 = np.where(body >= 0, (1.0 - bits)[:, np.maximum(body, 0)],
                  0.0).astype(np.float32)
    out = np.empty_like(m0)
    halo = min_run - 1
    idx = np.arange(length)
    w0 = np.maximum(0, (idx // 1024) * 1024 - halo)
    w1 = np.minimum(length, (idx // 1024 + 1) * 1024 + halo)
    for r, row in enumerate(m0):
        # each sample's run [start, stop) over the whole row
        change = np.ones(length, bool)
        change[1:] = row[1:] != row[:-1]
        start = np.maximum.accumulate(np.where(change, idx, 0))
        stop_change = np.ones(length, bool)
        stop_change[:-1] = row[1:] != row[:-1]
        stop = np.minimum.accumulate(
            np.where(stop_change, idx, length)[::-1])[::-1] + 1
        clipped = np.minimum(stop, w1) - np.maximum(start, w0)
        out[r] = np.where(clipped < min_run, np.float32(1.0) - row, row)
    return out


@pytest.mark.parametrize("pattern", ["random", "silent", "speech"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_long_window_mask_matches_sos_tpu(window, pattern):
    """Past 2^24 elements: the port's mask, K2's plain version (gate and
    complement) and K2's table all equal sos_tpu's mask exactly."""
    frames, samples = WINDOWS[window]
    assert frames * samples > tmix._DENSE_MASK_MAX_ELEMS
    bits = _bits(pattern, frames)
    ref = _sos_tpu_mask(bits, samples)
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), RATIO, samples)
    np.testing.assert_array_equal(got.numpy(), ref)
    y = np.random.default_rng(1).standard_normal(
        (len(bits), samples)).astype(np.float32)
    gate = tmix.mask_gate(torch.from_numpy(y), torch.from_numpy(bits), RATIO)
    comp = tmix.mask_gate(torch.from_numpy(y), torch.from_numpy(bits), RATIO,
                          complement=True)
    np.testing.assert_array_equal(gate.numpy(), y * ref)
    np.testing.assert_array_equal(comp.numpy(), y * (1.0 - ref))
    tables = tmix._gate_tables(frames, samples, RATIO, 5, CPU)
    assert not tables.despeckle and tables.span_frames <= 4
    np.testing.assert_array_equal(_kernel_gate_mask(tables, bits, frames), ref)


def test_length_not_a_multiple_of_four():
    """8 s plus 3 samples: the gather maps' tail and K2's scalar route."""
    frames, samples = 240, 112003
    bits = _bits("random", frames)
    ref = _sos_tpu_mask(bits, samples)
    got = tmix.mask_gate_plain(torch.ones(2, samples), torch.from_numpy(bits),
                               RATIO)
    np.testing.assert_array_equal(got.numpy(), ref)
    tables = tmix._gate_tables(frames, samples, RATIO, 5, CPU)
    np.testing.assert_array_equal(_kernel_gate_mask(tables, bits, frames), ref)


@pytest.mark.parametrize("window", ["2s", "8s"])
def test_generic_despeckle_matches_sos_tpu(window):
    """`despeckle_min_run` 600, above the frame body: sos_tpu's generic
    despeckle (dense at 2 s, gather maps at 8 s), the port's, K2's plain
    version and the despeckle instance's windowed count, exactly."""
    frames, samples = {"2s": (60, 28000), "8s": WINDOWS["8s"]}[window]
    rng = np.random.default_rng(3)
    # runs of 1-3 frames, so both short and long runs occur
    bits = np.repeat((rng.random((3, frames)) < 0.5), rng.integers(1, 4),
                     axis=1)[:, :frames].astype(np.float32)
    ref = _sos_tpu_mask(bits, samples, 600)
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), RATIO,
                                        samples, 600)
    np.testing.assert_array_equal(got.numpy(), ref)
    y = np.random.default_rng(4).standard_normal((3, samples)).astype(np.float32)
    comp = tmix.mask_gate_plain(torch.from_numpy(y), torch.from_numpy(bits),
                                RATIO, 600, complement=True)
    np.testing.assert_array_equal(comp.numpy(), y * (1.0 - ref))
    tables = tmix._gate_tables(frames, samples, RATIO, 600, CPU)
    assert tables.despeckle and tables.rows_per_block == 8
    np.testing.assert_array_equal(_kernel_despeckle_mask(tables, bits, 600), ref)
    # the flips happened: the generic despeckle is not the identity here
    undespeckled = _sos_tpu_mask(bits, samples, 1)
    assert np.any(ref != undespeckled)


@pytest.mark.parametrize("window", ["2s", "8s"])
def test_min_run_one_is_no_despeckle(window):
    frames, samples = {"2s": (60, 28000), "8s": WINDOWS["8s"]}[window]
    bits = _bits("random", frames)
    ref = _sos_tpu_mask(bits, samples, 1)
    got = tmix.bitstream_to_sample_mask(torch.from_numpy(bits), RATIO,
                                        samples, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    tables = tmix._gate_tables(frames, samples, RATIO, 1, CPU)
    assert not tables.despeckle and np.all(tables.words.numpy() >> 16 == -1)
    np.testing.assert_array_equal(_kernel_gate_mask(tables, bits, frames), ref)


@pytest.mark.parametrize("frames,samples,ratio,min_run", [
    (60, 28000, RATIO, 5),        # the 2 s clip
    (189, 88200, RATIO, 5),       # 6.3 s: the longest dense window
    (189, 88200, RATIO, 1),
    (20, 80, 4.0, 5),             # bodies shorter than min_run
    (10, 4000, RATIO, 5),         # clipped frame bodies
])
def test_table_words_from_maps_equal_the_dense_route(frames, samples, ratio,
                                                     min_run):
    """Where both routes apply, the words built in O(L) from the gather
    maps equal those read off the dense matrices (the single frame of
    each column of A, and of G)."""
    words, despeckle = tmix.gate_words(frames, samples, ratio, min_run)
    gap = tmix._despeckle_gap_matrix(frames, samples, ratio, min_run)
    assert despeckle == (gap is None)

    def owner(mat):
        assert np.all(mat.sum(axis=0) <= 1)
        return np.where(mat.any(axis=0), mat.argmax(axis=0), -1)

    body = owner(tmix.frame_sample_matrix(frames, samples, ratio))
    pair = owner(gap) if gap is not None else np.full(samples, -1)
    np.testing.assert_array_equal(words, ((pair.astype(np.int64) << 16)
                                          | (body & 0xFFFF)).astype(np.int32))


def test_gate_tables_name_their_limits():
    with pytest.raises(ValueError, match="32767"):
        tmix._gate_tables(32768, 32768 * 467, RATIO, 5, CPU)
    with pytest.raises(ValueError, match="despeckle_min_run 60000"):
        tmix._gate_tables(60, 28000, RATIO, 60000, CPU)
