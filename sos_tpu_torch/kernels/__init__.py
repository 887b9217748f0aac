"""The port's hand-written Hopper kernels: build, load, launch, count.

The kernels themselves live in `sos_tpu_torch/csrc/`; their wrappers and
plain PyTorch versions sit in the module of the op they replace:

  K1 `dsp/stft.py`   `stft_cat`       STFT (prime-factor real FFT; at
     other geometries its "fft" instance or the dense generic one)
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

K4 takes tiles of batch rows a block, a thread block cluster sharing a
tile's hidden units (`ops/lstm.py` `recurrence_plan`): each lane holds
its slice of W_hh in registers and h reaches the peers by stores counted
on their mbarriers, each tile walking to its longest row; K4b
(`backward_plan`) lays its BPTT out the same way, the dgates in h's
place (`csrc/cluster_exchange.cuh` holds what the two share). K5, K6's
spatial blocks with Cin % 16 == 0 and K7
(`csrc/int8_inpaint.cu`) run on the Hopper int8 tile
(`csrc/int8_wgmma.cuh`: wgmma fed by TMA); K6's Cin = 2 first layers and
1x1 float projections on kernels of their own (`csrc/int8_conv_edge.cu`);
the K6 and K7 shapes none of those takes on the `mma.sync` tile
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
