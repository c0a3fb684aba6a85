"""Entry points of the port: the serving driver and its step functions."""
