"""Launchers (the port of :mod:`repro.launch`): ``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``;
``steps`` builds their step functions."""
