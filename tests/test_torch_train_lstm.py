"""The BiLSTM's training path on the CPU: `bilstm_recurrence_backward_plain`
(K4b's plain version) against autograd of `bilstm_recurrence_plain` and
against `jax.vjp` of `sos_tpu.ops.lstm.lstm_scan` for both directions;
the training forward's saved state; `BiLSTMRecurrence` (CPU tensors take
the plain versions) inside `BiLSTM` against `jax.grad` of `sos_tpu`'s
`BiLSTM`. Tolerance: atol 1e-5 (fp32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from sos_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from sos_tpu_torch.kernels import LAUNCHES
from sos_tpu_torch.models.convert import bilstm_from_jax
from sos_tpu_torch.ops import lstm as tlstm

B, T, C = 3, 11, 6


def _recurrence_inputs(hidden, seed):
    rng = np.random.default_rng(seed)
    xp = [rng.standard_normal((B, T, 4 * hidden)).astype(np.float32)
          for _ in range(2)]
    w = [(rng.uniform(-1, 1, (4 * hidden, hidden)) / np.sqrt(hidden))
         .astype(np.float32) for _ in range(2)]
    dout = rng.standard_normal((B, T, 2 * hidden)).astype(np.float32)
    return xp, w, dout


@pytest.mark.parametrize("hidden", [4, 8])
def test_train_forward_keeps_c_and_gates(hidden):
    """The training forward's h is the inference recurrence's, bit for
    bit; its c and gates are the states the plain scan steps through."""
    (xp_f, xp_b), (w_f, w_b), _ = _recurrence_inputs(hidden, hidden)
    t = [torch.from_numpy(a) for a in (xp_f, xp_b, w_f, w_b)]
    out, c, gates = tlstm.bilstm_recurrence_train(*t)
    assert torch.equal(out, tlstm.bilstm_recurrence_plain(*t))
    assert c.shape == (2, B, T, hidden) and gates.shape == (2, B, T, 4 * hidden)
    # the forward direction's first step by hand
    pre = t[0][:, 0]
    i, f, g, o = pre.split(hidden, -1)
    i, g, o = torch.sigmoid(i), torch.tanh(g), torch.sigmoid(o)
    torch.testing.assert_close(c[0, :, 0], i * g, atol=1e-6, rtol=0)
    torch.testing.assert_close(out[:, 0, :hidden], o * torch.tanh(i * g),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(gates[0, :, 0, 2 * hidden:3 * hidden], g,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("hidden", [4, 8])
def test_backward_plain_matches_autograd(hidden):
    (xp_f, xp_b), (w_f, w_b), dout = _recurrence_inputs(hidden, 10 + hidden)
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in (xp_f, xp_b, w_f, w_b)]
    out = tlstm.bilstm_recurrence_plain(*xs)
    out.backward(torch.from_numpy(dout))
    with torch.no_grad():
        _, c, gates = tlstm.bilstm_recurrence_train(*[x.detach() for x in xs])
        dxp_f, dxp_b = tlstm.bilstm_recurrence_backward_plain(
            torch.from_numpy(dout), gates, c, xs[2].detach(), xs[3].detach())
    torch.testing.assert_close(dxp_f, xs[0].grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(dxp_b, xs[1].grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_backward_plain_matches_jax_vjp(reverse):
    """One direction at a time against `jax.vjp` of `lstm_scan`: d xp
    from K4b's plain version and dW_hh from the Function's product."""
    hidden = 8
    (xp_f, xp_b), (w_f, w_b), dout = _recurrence_inputs(hidden, 21)
    xp, w = (xp_b, w_b) if reverse else (xp_f, w_f)
    d_one = dout[..., hidden:] if reverse else dout[..., :hidden]
    # sos_tpu: (T, B, 4H) projections, w_hh (H, 4H)
    hs, vjp = jax.vjp(lambda a, b: jax_lstm_scan(a, b, reverse=reverse),
                      jnp.asarray(xp.transpose(1, 0, 2)), jnp.asarray(w.T))
    dxp_ref, dw_ref = vjp(jnp.asarray(d_one.transpose(1, 0, 2)))
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in (xp_f, xp_b, w_f, w_b)]
    out = tlstm.BiLSTMRecurrence.apply(*xs)
    half = out.detach()[..., hidden:] if reverse else out.detach()[..., :hidden]
    np.testing.assert_allclose(half.numpy(),
                               np.asarray(hs).transpose(1, 0, 2), atol=1e-5)
    grad = np.zeros_like(dout)
    if reverse:
        grad[..., hidden:] = d_one
    else:
        grad[..., :hidden] = d_one
    out.backward(torch.from_numpy(grad))
    k = 1 if reverse else 0
    np.testing.assert_allclose(xs[k].grad.numpy(),
                               np.asarray(dxp_ref).transpose(1, 0, 2),
                               atol=1e-5)
    np.testing.assert_allclose(xs[2 + k].grad.numpy(), np.asarray(dw_ref).T,
                               atol=1e-5)


def _bilstm_params(hidden, seed):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(hidden)
    u = lambda *shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    p = {}
    for d in ("fwd", "bwd"):
        p[f"w_ih_{d}"], p[f"w_hh_{d}"] = u(C, 4 * hidden), u(hidden, 4 * hidden)
        p[f"b_ih_{d}"], p[f"b_hh_{d}"] = u(4 * hidden), u(4 * hidden)
    return p


def test_bilstm_gradients_match_sos_tpu():
    """`BiLSTM` with a gradient goes through `BiLSTMRecurrence` (no
    launch on CPU tensors); every parameter's and the input's gradient
    match `jax.grad` of `sos_tpu`'s BiLSTM."""
    hidden = 8
    params = _bilstm_params(hidden, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    weight = rng.standard_normal((B, T, 2 * hidden)).astype(np.float32)

    def loss(p, xx):
        y = JaxBiLSTM(hidden=hidden).apply({"params": p}, xx)
        return jnp.sum(y * weight)
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    model = tlstm.BiLSTM(C, hidden)
    model.load_state_dict(bilstm_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    before = dict(LAUNCHES)
    y = model(xt)
    assert y.grad_fn is not None and "BiLSTMRecurrence" in type(y.grad_fn).__name__
    (y * torch.from_numpy(weight)).sum().backward()
    assert LAUNCHES == before  # CPU tensors take the plain versions
    ref = bilstm_from_jax(jax.tree.map(np.asarray, g_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5)


def test_gradient_through_lengths_raises():
    model = tlstm.BiLSTM(C, 4)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.5, 0.5)
    x = torch.zeros(2, T, C)
    with pytest.raises(ValueError, match="per-row lengths"):
        model(x, valid_len=torch.tensor([T, 3]))
    with torch.no_grad():  # inference keeps its per-row lengths
        assert model(x, valid_len=torch.tensor([T, 3])).shape == (2, T, 8)
