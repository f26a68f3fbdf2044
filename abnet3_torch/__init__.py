"""ABnet3 on PyTorch and CUDA: a port of ``abnet3_tpu`` to an NVIDIA H100.

The package mirrors ``abnet3_tpu``'s layout and public names, so each
module has its counterpart there, and it is held against that package by
the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax`` or anything of ``abnet3_tpu``: what it needs of that package's
host modules (``serialize``, ``io/h5f``, ``utils``) it keeps as copies.

Entry points (``TrainerSiamese``, ``SiameseNetwork``, ``TokenBank`` and the
loader's bank) run on the card unless the caller asks for the CPU with
``device="cpu"`` (or ``cuda=False`` on the trainer); without a card they
raise. The one hand-written kernel, the DTW path mask, is CUDA C++ in
``csrc/dtw_path.cu``, built with ``nvcc`` at first use.

Submodules are imported by their users; this file re-exports nothing.
"""

__version__ = "0.1.0"
