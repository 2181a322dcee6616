"""Drivers: one general program per kind of traffic, each reading its
parameters from a traffic file (``portbench/traffic/<mix>.json``, key
``driver``)."""
