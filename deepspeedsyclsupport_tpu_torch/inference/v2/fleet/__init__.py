"""Serving fleet: of the JAX package's ``inference/v2/fleet`` the port
carries, so far, the failover claim file that ``serve_worker`` reads; the
router and the replica pool are ROADMAP.md A.2.8."""
