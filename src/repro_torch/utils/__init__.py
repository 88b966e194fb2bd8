"""Host-side helpers of the port: tree walks, the name registry and the
event log."""
