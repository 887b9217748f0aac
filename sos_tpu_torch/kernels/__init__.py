"""The port's hand-written Hopper kernels: build, load, launch, count.

The kernels themselves live in `sos_tpu_torch/csrc/`; their wrappers and
plain PyTorch versions sit in the module of the op they replace:

  K1 `dsp/stft.py`   `stft_cat`       STFT (prime-factor real FFT)
  K2 `dsp/mixing.py` `mask_gate`      bits -> silence mask -> gate (or,
     `complement=True`, the gate by 1 - mask), any window length; its
     despeckle instance runs the generic run-length despeckle
  K3 `dsp/stft.py`   `crm_istft`      cRM recover + complex multiply + iSTFT
     (inverse prime-factor FFT, overlap-add)
  K4 `ops/lstm.py`   `bilstm_recurrence`  BiLSTM recurrence, both directions
     (`bilstm_recurrence_train`: its training instance, which also
     stores c and the activated gates)
  K4b `ops/lstm.py`  `bilstm_recurrence_backward`  the BiLSTM's backward
     through time, both directions (`csrc/bilstm_bwd.cu`)
  K5 `ops/int8_gemm.py` `int8_matmul_nt`  int8 GEMM, int32 out
  K6 `ops/int8_conv.py` `conv_same_int8`  int8 SAME conv + requantize
  K7 `ops/int8_conv.py` `inpaint_conv_int8`  int8 InpaintNet conv + PReLU
     requantize

K4 keeps W_hh in shared memory for all steps, with tiles of batch rows
a block (a thread block cluster of 4 shares H 200; `ops/lstm.py`
`recurrence_plan`). K5, K6's blocks with Cin % 16 == 0 and K7 (`csrc/int8_inpaint.cu`) run
on the Hopper int8 tile (`csrc/int8_wgmma.cuh`: wgmma fed by TMA); K6's
other blocks, and the K7 shapes its plan refuses, on the `mma.sync` tile
(`csrc/int8_mma.cuh`).
"""

from sos_tpu_torch.kernels.build import (  # noqa: F401
    ENTRY_LAUNCHES,
    LAUNCHES,
    aligned16,
    launch,
    library,
    on_device,
    reset_launches,
)
