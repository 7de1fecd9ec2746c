"""Median host time of a decode step's issue: the engine's
``engine.decode`` scopes (input staging and the model call up to its
return, before the argmax reaches the host) begun in the window, the
profiled slices' steps left out, in ms."""
from portbench import spans


def read(run):
    return spans.median_ms(run, "engine.decode")
