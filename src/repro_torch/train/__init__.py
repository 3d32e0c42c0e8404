"""LM training (the port of :mod:`repro.train`): ``optimizer`` (AdamW),
``checkpoint`` (the reference's ``.npz`` checkpoints) and ``train_loop``."""
