"""Launchers (the port of :mod:`repro.launch`): ``python -m
repro_torch.launch.serve``."""
