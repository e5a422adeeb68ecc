"""The port's launchers (``python -m repro_torch.launch.serve``)."""
