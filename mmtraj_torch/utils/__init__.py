"""Utilities of the port (counterpart of ``mmtraj/utils``)."""
