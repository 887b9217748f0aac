"""`chip_smoke.py`'s comparison of the BiLSTM's and heads' gradients,
card against CPU, checked on the CPU at small widths through its ReLU
masks (`head_forward(masks=)`): masks equal to each ReLU's own signs
change nothing, bit for bit, and one flipped unit moves its whole
gradient, which is why `head_agreement` gives the CPU the card's masks
and bounds how near 0 the units of differing sign lie."""

import pytest
import torch

import chip_smoke
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import init_state_dict
from tests.test_torch_kernels import _tiny_cfg

MODELS = {"detector": SilenceDetector, "denoiser": JointDenoiser}


@pytest.fixture(scope="module")
def heads():
    """Per stage: (cfg, weights, features x, logits' gradient g)."""
    cfg = _tiny_cfg()
    out = {}
    for stage, model in MODELS.items():
        gen = torch.Generator().manual_seed(5)
        sd = init_state_dict(model(getattr(cfg, stage)), gen)
        m = chip_smoke._init(stage, cfg, "cpu", sd).model
        lstm, _ = chip_smoke._head_modules(stage, m)
        x = torch.relu(torch.randn(2, 12, lstm.w_ih_fwd.shape[1],
                                   generator=gen))
        g = torch.randn(chip_smoke.head_forward(stage, m, x).shape,
                        generator=gen)
        out[stage] = (cfg, sd, x, g)
    return out


@pytest.mark.parametrize("stage", list(MODELS))
def test_own_relu_masks_change_nothing(heads, stage):
    cfg, sd, x, g = heads[stage]
    ref, z = chip_smoke.head_gradients(stage, cfg, sd, "cpu", x, g)
    got, z2 = chip_smoke.head_gradients(stage, cfg, sd, "cpu", x, g,
                                        masks=[p > 0 for p in z])
    assert len(z) == (1 if stage == "detector" else 2)
    assert all(torch.equal(a, b) for a, b in zip(z, z2))
    assert all(torch.equal(got[k], v) for k, v in ref.items())


@pytest.mark.parametrize("stage", list(MODELS))
def test_one_flipped_relu_unit_moves_its_gradient(heads, stage):
    """The first ReLU's unit nearest 0 takes the other branch: its row
    of the first linear layer's weight gradient moves, the others stay
    bit for bit, and the features' gradient moves."""
    cfg, sd, x, g = heads[stage]
    ref, z = chip_smoke.head_gradients(stage, cfg, sd, "cpu", x, g)
    masks = [p > 0 for p in z]
    flat = z[0].abs().argmin()
    masks[0].view(-1)[flat] = ~masks[0].view(-1)[flat]
    got, _ = chip_smoke.head_gradients(stage, cfg, sd, "cpu", x, g,
                                       masks=masks)
    unit = int(flat) % z[0].shape[-1]
    w = "fc.0.weight"
    others = torch.arange(ref[w].shape[0]) != unit
    assert torch.equal(got[w][others], ref[w][others])
    assert not torch.equal(got[w][unit], ref[w][unit])
    moved = (got["features"] - ref["features"]).abs().max()
    assert moved > 1e-4 * ref["features"].abs().max()
