"""Hand-written Hopper kernels of the port, one package per kernel
family, each with the reference's three-file shape: the CUDA source
(``csrc/*.cu``), the ``ops.py`` wrapper with the plain PyTorch version
beside it, and a ``ref.py`` oracle.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Kernels are built with ``nvcc`` at first use (see
``_build``), never at import.
"""
from repro_torch.kernels.qconv.ops import qconv2d_i8
from repro_torch.kernels.qmac.ops import qmac_i8, qmac_i8_deq

# the wrappers whose launches a run can count, by kernel name
WRAPPERS = {"qmac_i8": qmac_i8, "qmac_i8_deq": qmac_i8_deq,
            "qconv_i8_taps": qconv2d_i8}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "qconv2d_i8", "qmac_i8",
           "qmac_i8_deq", "reset_launch_counts"]
