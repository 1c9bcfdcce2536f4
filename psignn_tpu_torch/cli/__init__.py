"""Command-line entry points of the port (``python -m
psignn_tpu_torch.cli.main``)."""
