"""Per-layer metric readers: ``<metric>.py`` defines ``read(artifacts)``, a number or None."""
