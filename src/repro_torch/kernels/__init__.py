"""Hand-written Hopper kernels and their plain PyTorch versions.

Every wrapper in ``<kernel>/ops.py`` picks its path by the device of the
tensors it is given: CPU tensors go to the plain version in ``ref.py``,
CUDA tensors launch the CUDA kernel (built from ``repro_torch/csrc``), and
anything else raises.  Each kernel-launching wrapper counts its launches in
a plain integer attribute, ``<wrapper>.launches``.
"""
