"""Trace recorder (copy of :mod:`repro.telemetry.recorder`)."""
