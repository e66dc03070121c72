"""Entry points of the port: the serving Engine and its CLI."""
