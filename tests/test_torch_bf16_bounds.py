"""The bounds `chip_smoke.py` holds the card's bf16 train step to
(`BF16_BOUNDS`): how far bf16 moves `sos_tpu`'s own train step from its
f32 step at the reference depth (every conv block, 11 in the detector,
14 in each ContextAggNet encoder), at the small test widths, over two
weight draws and the batch seeds of `BF16_SEEDS`: the worst relative
loss gap and relative L2 of all gradients, strict bf16 as in
tests/test_torch_train.py. Each bound is that worst gap rounded up to
two digits (held within 25 % of it), so the card's bf16 step at full
width and depth is held to the distance bf16 rounding moves `sos_tpu`'s
step at that depth.

Run with `-s` to print the gaps."""

import chip_smoke
import pytest

from tests.test_torch_train import BF16_SEEDS, bf16_gap, sos_tpu_steps

WEIGHT_SEEDS = (3, 4)


@pytest.fixture(scope="module")
def full_depth_steps(tmp_path_factory):
    cases = [(stage, dtype, False) for stage in ("detector", "denoiser")
             for dtype in ("float32", "bfloat16")]
    return sos_tpu_steps(tmp_path_factory.mktemp("bf16_full_depth"), cases,
                         full_depth=True, weight_seeds=WEIGHT_SEEDS)


@pytest.mark.parametrize("stage", ["detector", "denoiser"])
def test_card_bf16_bounds_are_sos_tpus_own_gap(full_depth_steps, stage):
    gaps = [bf16_gap(full_depth_steps, f"{stage}/False/{w}/{seed}")
            for w in WEIGHT_SEEDS for seed in BF16_SEEDS]
    worst = tuple(max(g) for g in zip(*gaps))
    print(f"bf16 {stage}, full depth: sos_tpu bf16 against its f32 over "
          f"{len(gaps)} steps: worst loss {worst[0]:.3e}, gradients "
          f"{worst[1]:.3e}; median loss "
          f"{sorted(g[0] for g in gaps)[len(gaps) // 2]:.3e}, gradients "
          f"{sorted(g[1] for g in gaps)[len(gaps) // 2]:.3e}")
    for got, bound in zip(worst, chip_smoke.BF16_BOUNDS[stage]):
        assert got <= bound <= 1.25 * got, (stage, worst)
