"""Collective helpers of the port: the hang watchdog (rc 218 / 219)."""
