"""Entry points of the port: the serving Engine and the trainer, with
their CLIs."""
