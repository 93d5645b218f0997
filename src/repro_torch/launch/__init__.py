"""Entry points of the port's LM: ``python -m repro_torch.launch.serve``."""
