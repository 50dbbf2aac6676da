"""The port's command-line tools, run as
``python -m contextaware_poseformer_tpu_torch.tools.<name>``."""
