"""Load drivers: one module per kind of load, named by a traffic file's ``driver``."""
