"""Command-line entry points of the port (ports of `sos_tpu/cli/*`).

    python -m sos_tpu_torch.cli.denoise   one-shot wav -> wav (streaming)
    python -m sos_tpu_torch.cli.serve     long-lived denoising server

Both run on the CUDA card unless given `--device cpu`, and load
reference-layout `.pth` checkpoints (`--detector_pth`, `--denoiser_pth`).
The training, prediction and export CLIs are not ported yet (ROADMAP.md
queue 1).
"""
