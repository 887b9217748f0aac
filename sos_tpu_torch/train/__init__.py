"""Training: train states, train/eval steps, checkpoints, the epoch loop
on one device or data-parallel, joint training and the tensorboard
visualizer (port of `sos_tpu/train`)."""

from sos_tpu_torch.train.loop import (  # noqa: F401
    init_denoiser_state,
    init_detector_state,
    make_denoiser_eval_step,
    make_denoiser_train_step,
    make_detector_eval_step,
    make_detector_train_step,
    make_lr_schedule,
)
from sos_tpu_torch.train.state import TrainClock, TrainState  # noqa: F401
