"""Training of the port: losses, metrics, steps, checkpoints, the loop and
the Human3.6M driver."""
