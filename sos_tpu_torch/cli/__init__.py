"""Command-line entry points of the port (ports of `sos_tpu/cli/*`).

    python -m sos_tpu_torch.cli.denoise           one-shot wav -> wav (streaming)
    python -m sos_tpu_torch.cli.serve             long-lived denoising server
    python -m sos_tpu_torch.cli.predict_detector  stage-1 eval over a dataset JSON
    python -m sos_tpu_torch.cli.bridge            stage-1 results -> stage-2 input
    python -m sos_tpu_torch.cli.predict_denoiser  stage-2 eval with the metric suite
    python -m sos_tpu_torch.cli.train_detector    train stage 1 (one device, f32)
    python -m sos_tpu_torch.cli.train_denoiser    train stage 2 (one device, f32)

They run on the CUDA card unless given `--device cpu`. The serving and
eval CLIs load reference-layout `.pth` checkpoints (`--detector_pth`,
`--denoiser_pth`; `--pth` for the predict CLIs); the train CLIs write
and resume torch-format checkpoints (`train/checkpoints.py`). The joint
training, report and export CLIs are not ported yet (ROADMAP.md queue 1).
"""
