"""Configurations: ``<name>.json`` holds the sizes as run, ``<name>.py``
draws the weights and builds the program's server."""
