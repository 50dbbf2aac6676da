"""Context-Aware PoseFormer in PyTorch for NVIDIA Hopper (H100).

The port of ``contextaware_poseformer_tpu`` (JAX/Pallas on TPU), which stays
beside it as the reference. Module paths and class names mirror the JAX
package. The package imports ``torch`` and never ``jax``, ``flax`` or anything of the
JAX package: what it needs of the JAX package's framework-neutral modules
(``config``, ``utils/skeleton``, ``utils/geometry``, ``data/synthetic``,
``data/h36m`` and its loaders) it keeps as its own copies.

Plain tensor code is PyTorch; each Pallas kernel of the ported paths is a
hand-written CUDA kernel for ``sm_90a`` under ``ops/csrc``, built at first
use (``ops/_build.py``). Entry points: ``serve.py`` (serving) and
``train/train_h36m.py`` (training).
"""

__version__ = "0.1.0"
