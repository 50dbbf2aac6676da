"""The benchmark's plain reference of Context-Aware PoseFormer.

Plain PyTorch in float32, NCHW, written from the published architecture and
from the configuration files under ``portbench/configs``: the CPN backbone
(ResNet-50, globalNet, refineNet) with the int8 residual stream of the
deploy graph and its calibration, the context-aware lifter with its
deformable context blocks, the MPJPE loss and AdamW. It imports nothing of
the program and takes nothing the program made: it reads the benchmark's
state dict (``portbench/weights.py``), the benchmark's frames and
keypoints, and works out the int8 weights and the calibration scales again.

Parameter names follow the program's state dict so that one dict of seeded
weights serves both sides; ``param_specs`` lists them from the configuration
alone.

``levels`` is the largest quantized magnitude: 127 for int8, 7 for the
lower-precision control (int4).
"""
