"""Runnable measurements of the port (``python -m conjugategradient_tpu_torch.scripts.<name>``)."""
