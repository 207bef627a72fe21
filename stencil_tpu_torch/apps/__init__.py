"""Command-line apps (``python -m stencil_tpu_torch.apps.<name>``)."""
