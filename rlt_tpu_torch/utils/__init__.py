"""Utilities of the port: device choice, metrics, parameter conversion."""
