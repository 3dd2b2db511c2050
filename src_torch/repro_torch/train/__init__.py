"""Step functions of the port (port of ``repro/train``): serving steps only;
the training steps come with the training slice (ROADMAP queue 1, item 12)."""
