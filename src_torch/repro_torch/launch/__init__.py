"""Launchers of the port (port of ``repro/launch``): the training and
serving launchers and the aggregation mesh."""
