"""Runtime sanitizers of the port (:mod:`repro_torch.analysis.sanitizers`),
imported explicitly by tests and ``chip_smoke.py``. The static analyzer
stays the reference's (``python -m repro.analysis src/`` scans this package
too)."""
