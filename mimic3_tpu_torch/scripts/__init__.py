"""Command-line tools of the port (``python -m mimic3_tpu_torch.scripts.<name>``)."""
