"""Seconds of the built step's first call (the program's ``setup.first_step``
span, host_totals.py): the first launch of each of its operations."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.seconds(host_totals.totals(), ("setup.first_step",))
