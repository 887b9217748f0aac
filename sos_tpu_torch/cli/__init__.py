"""Command-line entry points of the port (ports of `sos_tpu/cli/*`).

    python -m sos_tpu_torch <command> [args...]   (the dispatcher, __main__.py)

    preprocess        a directory of WAVs -> the dataset JSON (host)
    train_detector    train stage 1 (f32 or bf16; one device or data-parallel)
    train_denoiser    train stage 2 (the same)
    train_joint       train both stages together, one step for both
    import_checkpoint a reference `.pth` -> the experiment's torch checkpoints
    predict_detector  stage-1 eval over a dataset JSON
    bridge            stage-1 results -> stage-2 input
    predict_denoiser  stage-2 eval with the metric suite
    report            per-SNR tables and plots, training curves (host)
    eval_synthetic    batched synthetic-mixture quality eval per SNR
    denoise           one-shot wav -> wav (streaming)
    serve             long-lived denoising server
    calibrate         offline int8 activation scales from a corpus
    export_serving    the fused pipeline as a serving artifact
                      (`infer/export.py` `load_denoise_program`)
    parity_check      released `.pth` -> end to end -> deltas vs a manifest
    doctor            environment and deployment diagnostics

Each runs as `python -m sos_tpu_torch.cli.<command>` too. Those with
device work run on the CUDA card unless given `--device cpu`. The serving, eval and ops
CLIs read the experiment's own checkpoints (`--ckpt`/`--*_ckpt`,
default `latest`) or reference-layout `.pth` files (`--pth`,
`--detector_pth`, `--denoiser_pth`); the train CLIs write and resume
torch-format checkpoints (`train/checkpoints.py`).
"""
