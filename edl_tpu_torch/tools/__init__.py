"""Command-line tools of the port (``python -m edl_tpu_torch.tools.<name>``)."""
