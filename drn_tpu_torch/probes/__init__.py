"""Measurement probes of the port, each the twin of a script in scripts/."""
