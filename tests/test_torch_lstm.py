"""Port BiLSTM (`sos_tpu_torch.ops.lstm`, kernel K4's module) against
`sos_tpu.ops.lstm`, on the CPU. Tolerance: atol=1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sos_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from sos_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models.convert import bilstm_from_jax
from sos_tpu_torch.ops import lstm as tlstm

B, T, C, H = 2, 13, 24, 8


def _params(seed: int):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    u = lambda *shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    p = {}
    for d in ("fwd", "bwd"):
        p[f"w_ih_{d}"], p[f"w_hh_{d}"] = u(C, 4 * H), u(H, 4 * H)
        p[f"b_ih_{d}"], p[f"b_hh_{d}"] = u(4 * H), u(4 * H)
    return p


@pytest.mark.parametrize("valid_len", [None, 9])
@pytest.mark.parametrize("bf16_proj", [False, True])
def test_bilstm_matches_sos_tpu(valid_len, bf16_proj):
    params = _params(1)
    x = np.random.default_rng(2).standard_normal((B, T, C)).astype(np.float32)
    ref = np.asarray(JaxBiLSTM(hidden=H, bf16_proj=bf16_proj).apply(
        {"params": params}, jnp.asarray(x),
        valid_len=None if valid_len is None else jnp.asarray(valid_len)))
    model = tlstm.BiLSTM(C, H, bf16_proj=bf16_proj)
    model.load_state_dict(bilstm_from_jax(params))
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = model(torch.from_numpy(x), valid_len=valid_len).numpy()
    assert LAUNCHES == before  # CPU tensors take the plain recurrence
    assert got.shape == ref.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if valid_len is not None:
        assert not got[:, valid_len:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_scan_matches_sos_tpu(reverse, masked):
    rng = np.random.default_rng(3)
    xp = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = (np.arange(T) < 7).astype(np.float32) if masked else None
    ref = np.asarray(jax_lstm_scan(
        jnp.asarray(xp), jnp.asarray(w_hh), reverse=reverse,
        step_mask=None if mask is None else jnp.asarray(mask)))
    got = tlstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(w_hh),
                          reverse=reverse,
                          step_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("reverse,masked", [(False, False), (True, True)])
def test_lstm_scan_matches_sos_tpu_at_hidden_256(reverse, masked):
    """The plain path at a hidden size past K4's register plans (the wide
    route's, H 256) against sos_tpu's `lstm_scan`: atol 1e-4 (sums of 256
    products in another order)."""
    hidden, steps = 256, 5
    rng = np.random.default_rng(5)
    xp = rng.standard_normal((steps, B, 4 * hidden)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (hidden, 4 * hidden))
            / np.sqrt(hidden)).astype(np.float32)
    mask = (np.arange(steps) < 3).astype(np.float32) if masked else None
    ref = np.asarray(jax_lstm_scan(
        jnp.asarray(xp), jnp.asarray(w_hh), reverse=reverse,
        step_mask=None if mask is None else jnp.asarray(mask)))
    got = tlstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(w_hh),
                          reverse=reverse,
                          step_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_bilstm_recurrence_layout():
    """Output is (B, T, 2H) = [forward | backward] of the per-direction scans."""
    rng = np.random.default_rng(4)
    xp_f, xp_b = (torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32))
                  for _ in range(2))
    w_f, w_b = (torch.from_numpy((rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32))
                for _ in range(2))
    out = tlstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b)
    fwd = tlstm.lstm_scan(xp_f.transpose(0, 1), w_f.t()).transpose(0, 1)
    bwd = tlstm.lstm_scan(xp_b.transpose(0, 1), w_b.t(), reverse=True).transpose(0, 1)
    torch.testing.assert_close(out, torch.cat([fwd, bwd], -1), atol=0, rtol=0)
