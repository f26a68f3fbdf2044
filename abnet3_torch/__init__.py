"""ABnet3 on PyTorch and CUDA: a port of ``abnet3_tpu`` to an NVIDIA H100.

The package mirrors ``abnet3_tpu``'s layout and public names, so each
module has its counterpart there, and it is held against that package by
the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax`` or anything of ``abnet3_tpu``: what it needs of that package's
host modules (``serialize``, ``io/h5f``, ``utils``, ``sampler``) it keeps
as copies.

Entry points: ``FeaturesGenerator`` (wavs -> features, and its CLI
``python -m abnet3_torch.features``), ``SamplerClusterSiamese`` (host
only), ``OriginalDataLoader``, ``SiameseNetwork``, ``TrainerSiamese``,
``EmbedderSiamese``, their multitask counterparts
(``MultiTaskDataLoader``, ``SiameseMultitaskNetwork``,
``TrainerSiameseMultitask``, ``EmbedderSiameseMultitask``),
``eval.abx.evaluate`` (and its CLI) and the
orchestrator ``GridSearch`` (``python -m abnet3_torch.gridsearch
exp.yaml``). They run on the card unless the caller asks for the CPU with
``device="cpu"`` (or ``cuda=False`` on the trainer and the embedder);
without a card they raise. ``FeaturesGenerator`` too defaults to the card
for its spectral transform. The hand-written kernels, the DTW path mask
(training), the DTW moves (the device loader) and the DTW path statistics
(ABX distances), are CUDA C++ in ``csrc/``, built with ``nvcc`` at first
use.

Submodules are imported by their users; this file re-exports nothing.
"""

__version__ = "0.1.0"
