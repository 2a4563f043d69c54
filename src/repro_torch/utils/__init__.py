"""Utilities of the port (``comms``: the dry run's collective bytes)."""
