"""gmrm_tpu_torch — the PyTorch / CUDA (Hopper) port of gmrm_tpu.

The same BayesR-family Gibbs sampler as :mod:`gmrm_tpu`, on one NVIDIA
H100: plain tensor code is PyTorch, and every Pallas kernel of the
training paths is a hand-written CUDA C++ kernel for
``sm_90a`` (``gmrm_tpu_torch/csrc``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/_build.py``).  On CPU tensors each kernel
wrapper runs the kernel's plain PyTorch version instead, which is what the
CPU tests hold against the JAX package.

This package imports ``torch`` and never ``jax``, ``flax`` or anything of
``gmrm_tpu``: it has its own copies of the NumPy-only modules it needs (the
I/O readers and writers, the simulator, ``Options`` and the CLI parser).

The slices covered so far are training on one device: wave mode (W > 1)
through the whole-sweep kernel, one launch per iteration (the composed
per-block path stays behind ``megakernel=False``), and the exact serial
sweep (W = 1); and marker-sharded training over ``torch.distributed``
(``gmrm_tpu_torch.parallel``), through the fused per-block kernel; and
predict (``gmrm_tpu_torch.predict``), whose per-marker sums are one more
hand-written kernel; and chain checkpoints and the startup cache
(``gmrm_tpu_torch.checkpoint``, ``gmrm_tpu_torch.startup_cache``), on one
device and sharded.  See ROADMAP.md for what is still to be ported.
"""

__version__ = "0.1.0"

from gmrm_tpu_torch.config import Options  # noqa: F401
