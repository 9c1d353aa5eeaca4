"""Measurement tools of the port (port of the repo's ``tools/``)."""
