"""Launchers of the port (port of ``repro/launch``): the serving launcher
and the aggregation mesh."""
