"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper takes CPU tensors to its plain version and CUDA tensors to its
kernel; it raises on any other device. ``LAUNCHES`` counts kernel launches
per wrapper.
"""

from ._lib import LAUNCHES, reset_launches  # noqa: F401
