"""Scheduling policies (copy of :mod:`repro.bench.policy`)."""
