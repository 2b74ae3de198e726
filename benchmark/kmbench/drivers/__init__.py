"""One module per kind of traffic: ``count`` and ``catalog``. A traffic
file names its driver with its ``driver`` key."""
