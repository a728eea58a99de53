"""Runnable compositions of the port's operators."""
