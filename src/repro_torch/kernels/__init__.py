"""Hand-written Hopper kernels of the port, one package per kernel
family, each with the reference's three-file shape: the CUDA source
(``csrc/*.cu``), the ``ops.py`` wrapper with the plain PyTorch version
beside it, and a ``ref.py`` oracle.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Kernels are built with ``nvcc`` at first use (see
``_build``), never at import.
"""
from repro_torch.kernels.qconv.ops import qconv2d_i8
from repro_torch.kernels.qlstm.ops import qlstm_cell
from repro_torch.kernels.qmac.ops import qmac_i8, qmac_i8_deq, qmac_i8_deq_bmm
from repro_torch.kernels.vact.ops import vact, vact_ew, vact_q8, vact_softmax

# the wrappers whose launches a run can count, by kernel name
WRAPPERS = {"qmac_i8": qmac_i8, "qmac_i8_deq": qmac_i8_deq,
            "qmac_i8_deq_bmm": qmac_i8_deq_bmm,
            "qconv_i8_taps": qconv2d_i8, "vact_ew": vact_ew,
            "vact_ew_q8": vact_q8, "vact_softmax": vact_softmax,
            "qlstm_cell": qlstm_cell}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "qconv2d_i8", "qlstm_cell",
           "qmac_i8", "qmac_i8_deq", "qmac_i8_deq_bmm",
           "reset_launch_counts", "vact",
           "vact_ew", "vact_q8", "vact_softmax"]
