"""Command-line entry points of the port (ports of `sos_tpu/cli/*`).

    python -m sos_tpu_torch.cli.denoise           one-shot wav -> wav (streaming)
    python -m sos_tpu_torch.cli.serve             long-lived denoising server
    python -m sos_tpu_torch.cli.predict_detector  stage-1 eval over a dataset JSON
    python -m sos_tpu_torch.cli.bridge            stage-1 results -> stage-2 input
    python -m sos_tpu_torch.cli.predict_denoiser  stage-2 eval with the metric suite

They run on the CUDA card unless given `--device cpu`, and load
reference-layout `.pth` checkpoints (`--detector_pth`, `--denoiser_pth`;
`--pth` for the predict CLIs). The training and export CLIs are not
ported yet (ROADMAP.md queue 1).
"""
