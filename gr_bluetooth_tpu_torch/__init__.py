"""gr_bluetooth_tpu_torch — the PyTorch/CUDA port of gr_bluetooth_tpu.

Same layer map as the JAX package (models/, ops/, io/, core/, utils/),
each module named after its counterpart there.  Hot kernels are written
by hand in CUDA C++ for Hopper (csrc/, built with nvcc at first use and
bound with ctypes); every kernel wrapper keeps a plain PyTorch version
of the same function beside it, which runs only for tensors on the CPU.

Entry points (FrontEnd, LapSurvey, the kernel wrappers) run on the CUDA
device unless the caller passes device="cpu"; with no card and no
device given they raise.  The package imports torch and numpy only.
"""

__version__ = "0.1.0"
