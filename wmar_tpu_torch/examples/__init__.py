"""Runnable demos of the port (``python -m wmar_tpu_torch.examples.<name>``)."""
