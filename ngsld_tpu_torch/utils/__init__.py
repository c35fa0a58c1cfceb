"""Shared helpers of the port's checks."""
