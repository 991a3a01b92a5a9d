"""Command-line apps of the port (``python -m raytrace_tpu_torch.apps.<name>``)."""
