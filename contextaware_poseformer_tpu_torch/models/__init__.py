"""Models of the port: lifter, CPN backbone, composite and the flax
weight bridge."""
