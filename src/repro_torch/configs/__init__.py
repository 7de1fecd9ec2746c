"""Model configurations (copies of :mod:`repro.configs`)."""
