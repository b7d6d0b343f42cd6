"""Launchers of the port (port of ``repro.launch``)."""
