"""Counterparts of the JAX package's TPU probes under ``experiments/``
(kernels written to measure, not served): builds of K9's and K10's CUDA
code and one small window-shift kernel, each beside its plain version.
No model path imports them; ``chip_smoke.py``'s probes phase runs them."""
