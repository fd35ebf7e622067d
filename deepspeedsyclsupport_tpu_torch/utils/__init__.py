"""Host-side helpers of the port: logging, pod identity, fault injection."""
